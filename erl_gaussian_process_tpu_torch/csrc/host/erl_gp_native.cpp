// Native host-runtime components (C ABI, loaded via ctypes).
//
// The reference implements its host runtime in C++ (binary data loading via
// erl_common LoadBinaryFile + TrainDataLoader, test/gtest/test_lidar_gp_2d
// .cpp:82-115; token-tagged checkpoint streams via common::Serialization<T>
// WriteTokens/ReadTokens, src/vanilla_gp.cpp:606-790; simulated lidar via
// erl_geometry Lidar2D/Space2D). The PyTorch port keeps its compute path on
// the GPU and mirrors those host pieces natively here (this file is the
// port's own copy of the JAX package's native/erl_gp_native.cpp; the two
// write identical token files):
//
//   1. lidar-log parser  — the packed 2D scan log format
//      (int32 numel | dtype angles[numel] | dtype ranges[numel] |
//       uint64 pose_size | dtype pose[pose_size]) repeated to EOF.
//   2. token checkpoint  — named-tensor binary streams: fast bulk fwrite
//      /fread with a tagged directory, used for model checkpoints.
//   3. raycasters        — batched 2D ray/segment and 3D ray/triangle
//      intersection with OpenMP, the data generators for mapping tests and
//      benchmarks.
//
// Build: erl_gaussian_process_tpu_torch/utils/native.py (g++ -O3 -shared
// -fPIC -fopenmp, at first use). Python fallbacks exist for every entry
// point.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

#define EGP_API extern "C" __attribute__((visibility("default")))

// ---------------------------------------------------------------- lidar log

namespace {

struct LogFrame {
    std::vector<double> angles;
    std::vector<double> ranges;
    std::vector<double> pose;  // column-major 2x3 [t | R]
};

struct LogHandle {
    std::vector<LogFrame> frames;
};

template <typename T>
bool read_exact(std::FILE* f, T* out, size_t n) {
    return std::fread(out, sizeof(T), n, f) == n;
}

template <typename Dtype>
bool parse_log(std::FILE* f, std::vector<LogFrame>& frames) {
    for (;;) {
        int32_t numel = 0;
        size_t got = std::fread(&numel, sizeof(numel), 1, f);
        if (got == 0) return true;  // clean EOF
        if (numel <= 0 || numel > (1 << 24)) return false;
        std::vector<Dtype> a(numel), r(numel);
        if (!read_exact(f, a.data(), numel)) return false;
        if (!read_exact(f, r.data(), numel)) return false;
        uint64_t pose_size = 0;
        if (!read_exact(f, &pose_size, 1)) return false;
        if (pose_size > 64) return false;
        std::vector<Dtype> p(pose_size);
        if (!read_exact(f, p.data(), pose_size)) return false;
        LogFrame fr;
        fr.angles.assign(a.begin(), a.end());
        fr.ranges.assign(r.begin(), r.end());
        fr.pose.assign(p.begin(), p.end());
        frames.push_back(std::move(fr));
    }
}

}  // namespace

// dtype_code: 0 = float64, 1 = float32
EGP_API void* egp_log_open(const char* path, int dtype_code) {
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    auto* h = new LogHandle();
    bool ok = dtype_code == 0 ? parse_log<double>(f, h->frames)
                              : parse_log<float>(f, h->frames);
    std::fclose(f);
    if (!ok) {
        delete h;
        return nullptr;
    }
    return h;
}

EGP_API int64_t egp_log_num_frames(void* handle) {
    return static_cast<LogHandle*>(handle)->frames.size();
}

EGP_API int64_t egp_log_frame_numel(void* handle, int64_t i) {
    return static_cast<LogHandle*>(handle)->frames[i].angles.size();
}

EGP_API int64_t egp_log_frame_pose_size(void* handle, int64_t i) {
    return static_cast<LogHandle*>(handle)->frames[i].pose.size();
}

EGP_API void egp_log_frame(void* handle, int64_t i, double* angles,
                           double* ranges, double* pose) {
    const LogFrame& fr = static_cast<LogHandle*>(handle)->frames[i];
    std::memcpy(angles, fr.angles.data(), fr.angles.size() * sizeof(double));
    std::memcpy(ranges, fr.ranges.data(), fr.ranges.size() * sizeof(double));
    std::memcpy(pose, fr.pose.data(), fr.pose.size() * sizeof(double));
}

EGP_API void egp_log_close(void* handle) {
    delete static_cast<LogHandle*>(handle);
}

// --------------------------------------------------- token checkpoint store
//
// Format (little-endian):
//   magic "EGPT" | uint32 version=1 | uint64 n_entries
//   per entry: uint32 name_len | name bytes | uint32 dtype_code
//              | uint32 ndim | uint64 shape[ndim] | uint64 nbytes
//              | raw data bytes
// dtype codes follow numpy kind/size: 0=f64 1=f32 2=i64 3=i32 4=u8 5=bool

namespace {

struct CkptEntry {
    std::string name;
    uint32_t dtype;
    std::vector<uint64_t> shape;
    std::vector<uint8_t> data;
};

struct CkptHandle {
    std::vector<CkptEntry> entries;
};

constexpr char kMagic[5] = "EGPT";

}  // namespace

EGP_API int egp_ckpt_write(const char* path, int64_t n_entries,
                           const char** names, const uint32_t* dtypes,
                           const uint32_t* ndims, const uint64_t* shapes,
                           const void** datas, const uint64_t* nbytes) {
    std::FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    uint32_t version = 1;
    uint64_t n = static_cast<uint64_t>(n_entries);
    std::fwrite(kMagic, 1, 4, f);
    std::fwrite(&version, sizeof(version), 1, f);
    std::fwrite(&n, sizeof(n), 1, f);
    const uint64_t* shape_ptr = shapes;
    for (int64_t i = 0; i < n_entries; ++i) {
        uint32_t name_len = static_cast<uint32_t>(std::strlen(names[i]));
        std::fwrite(&name_len, sizeof(name_len), 1, f);
        std::fwrite(names[i], 1, name_len, f);
        std::fwrite(&dtypes[i], sizeof(uint32_t), 1, f);
        std::fwrite(&ndims[i], sizeof(uint32_t), 1, f);
        std::fwrite(shape_ptr, sizeof(uint64_t), ndims[i], f);
        shape_ptr += ndims[i];
        std::fwrite(&nbytes[i], sizeof(uint64_t), 1, f);
        if (std::fwrite(datas[i], 1, nbytes[i], f) != nbytes[i]) {
            std::fclose(f);
            return -2;
        }
    }
    std::fclose(f);
    return 0;
}

EGP_API void* egp_ckpt_open(const char* path) {
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    char magic[4];
    uint32_t version;
    uint64_t n;
    if (!read_exact(f, magic, 4) || std::memcmp(magic, kMagic, 4) != 0 ||
        !read_exact(f, &version, 1) || version != 1 ||
        !read_exact(f, &n, 1)) {
        std::fclose(f);
        return nullptr;
    }
    auto* h = new CkptHandle();
    h->entries.reserve(n);
    for (uint64_t i = 0; i < n; ++i) {
        CkptEntry e;
        uint32_t name_len, ndim;
        if (!read_exact(f, &name_len, 1) || name_len > 4096) goto fail;
        e.name.resize(name_len);
        if (!read_exact(f, e.name.data(), name_len)) goto fail;
        if (!read_exact(f, &e.dtype, 1)) goto fail;
        if (!read_exact(f, &ndim, 1) || ndim > 16) goto fail;
        e.shape.resize(ndim);
        if (ndim && !read_exact(f, e.shape.data(), ndim)) goto fail;
        uint64_t nbytes;
        if (!read_exact(f, &nbytes, 1)) goto fail;
        e.data.resize(nbytes);
        if (nbytes && !read_exact(f, e.data.data(), nbytes)) goto fail;
        h->entries.push_back(std::move(e));
    }
    std::fclose(f);
    return h;
fail:
    std::fclose(f);
    delete h;
    return nullptr;
}

EGP_API int64_t egp_ckpt_num(void* handle) {
    return static_cast<CkptHandle*>(handle)->entries.size();
}

EGP_API const char* egp_ckpt_name(void* handle, int64_t i) {
    return static_cast<CkptHandle*>(handle)->entries[i].name.c_str();
}

EGP_API uint32_t egp_ckpt_dtype(void* handle, int64_t i) {
    return static_cast<CkptHandle*>(handle)->entries[i].dtype;
}

EGP_API uint32_t egp_ckpt_ndim(void* handle, int64_t i) {
    return static_cast<CkptHandle*>(handle)->entries[i].shape.size();
}

EGP_API void egp_ckpt_shape(void* handle, int64_t i, uint64_t* out) {
    const auto& s = static_cast<CkptHandle*>(handle)->entries[i].shape;
    std::memcpy(out, s.data(), s.size() * sizeof(uint64_t));
}

EGP_API uint64_t egp_ckpt_nbytes(void* handle, int64_t i) {
    return static_cast<CkptHandle*>(handle)->entries[i].data.size();
}

EGP_API void egp_ckpt_data(void* handle, int64_t i, void* out) {
    const auto& d = static_cast<CkptHandle*>(handle)->entries[i].data;
    std::memcpy(out, d.data(), d.size());
}

EGP_API void egp_ckpt_close(void* handle) {
    delete static_cast<CkptHandle*>(handle);
}

// ----------------------------------------------------------- 2D raycaster
//
// Batched ray vs segment-soup intersection (the erl_geometry Lidar2D /
// Space2D equivalent used to simulate scans in tests and bench). For each
// (origin, angle) find the nearest hit distance among all segments; misses
// produce +inf.

EGP_API void egp_raycast_2d(const double* segs, int64_t n_segs,
                            const double* origins, const double* angles,
                            int64_t n_rays, double max_range, double* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < n_rays; ++r) {
        const double ox = origins[2 * r], oy = origins[2 * r + 1];
        const double dx = std::cos(angles[r]), dy = std::sin(angles[r]);
        double best = max_range;
        bool hit = false;
        for (int64_t s = 0; s < n_segs; ++s) {
            const double x1 = segs[4 * s], y1 = segs[4 * s + 1];
            const double x2 = segs[4 * s + 2], y2 = segs[4 * s + 3];
            const double ex = x2 - x1, ey = y2 - y1;
            const double denom = dx * ey - dy * ex;
            if (std::fabs(denom) < 1e-15) continue;
            const double qx = x1 - ox, qy = y1 - oy;
            const double t = (qx * ey - qy * ex) / denom;   // along ray
            const double u = (qx * dy - qy * dx) / denom;   // along segment
            if (t >= 0.0 && u >= 0.0 && u <= 1.0 && t < best) {
                best = t;
                hit = true;
            }
        }
        out[r] = hit ? best : INFINITY;
    }
}

// --------------------------------------------------------- 3D mesh raycaster
//
// Batched Moller-Trumbore ray vs triangle-soup intersection with OpenMP —
// the host-side equivalent of the Open3D RaycastingScene the reference's 3D
// tests use for ground truth (test/gtest/test_range_sensor_gp_3d.cpp:59-109).
// tris: (T, 9) [v0 v1 v2] row-major; origins/dirs: (R, 3); misses -> +inf.

EGP_API void egp_raycast_mesh(const double* tris, int64_t n_tris,
                              const double* origins, const double* dirs,
                              int64_t n_rays, double max_range, double* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < n_rays; ++r) {
        const double ox = origins[3 * r], oy = origins[3 * r + 1],
                     oz = origins[3 * r + 2];
        const double dx = dirs[3 * r], dy = dirs[3 * r + 1],
                     dz = dirs[3 * r + 2];
        double best = max_range;
        bool hit = false;
        for (int64_t t = 0; t < n_tris; ++t) {
            const double* v = tris + 9 * t;
            const double e1x = v[3] - v[0], e1y = v[4] - v[1],
                         e1z = v[5] - v[2];
            const double e2x = v[6] - v[0], e2y = v[7] - v[1],
                         e2z = v[8] - v[2];
            // p = d x e2
            const double px = dy * e2z - dz * e2y;
            const double py = dz * e2x - dx * e2z;
            const double pz = dx * e2y - dy * e2x;
            const double det = e1x * px + e1y * py + e1z * pz;
            if (std::fabs(det) < 1e-14) continue;
            const double inv = 1.0 / det;
            const double sx = ox - v[0], sy = oy - v[1], sz = oz - v[2];
            const double u = (sx * px + sy * py + sz * pz) * inv;
            if (u < 0.0 || u > 1.0) continue;
            // q = s x e1
            const double qx = sy * e1z - sz * e1y;
            const double qy = sz * e1x - sx * e1z;
            const double qz = sx * e1y - sy * e1x;
            const double w = (dx * qx + dy * qy + dz * qz) * inv;
            if (w < 0.0 || u + w > 1.0) continue;
            const double tt = (e2x * qx + e2y * qy + e2z * qz) * inv;
            if (tt > 1e-9 && tt < best) {
                best = tt;
                hit = true;
            }
        }
        out[r] = hit ? best : INFINITY;
    }
}

EGP_API int egp_version() { return 1; }
