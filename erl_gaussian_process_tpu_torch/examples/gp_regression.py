"""GP regression walkthrough: exact GP, noisy-input GP with gradient
observations, sparse pseudo-input GP, and a reduced-rank (Hilbert) GP on the
same 1D problem, then marginal-likelihood scale selection and a scale
mixture (counterpart of the JAX package's ``examples/gp_regression.py``).

Usage: python -m erl_gaussian_process_tpu_torch.examples.gp_regression
       [--device cpu]
"""

import argparse

import numpy as np

from erl_gaussian_process_tpu_torch.api import (
    NoisyInputGaussianProcessD,
    SparsePseudoInputGaussianProcessD,
    VanillaGaussianProcessD,
)
from erl_gaussian_process_tpu_torch.kernels import (
    KernelSetting,
    ReducedRankSetting,
)
from erl_gaussian_process_tpu_torch.models import (
    NoisyInputGPSetting,
    SpGpSetting,
    VanillaGaussianProcess,
    VanillaGPSetting,
)
from erl_gaussian_process_tpu_torch.utils import (
    select_scale,
    select_scale_nigp,
    select_scale_spgp,
)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else \
        np.asarray(t)


def main(device: str = "cuda"):
    rng = np.random.default_rng(0)
    n = 200
    x = np.sort(rng.uniform(-0.9, 0.9, n))[None, :]    # (x_dim, n)
    f = np.sin(3 * x[0])
    y = (f + rng.normal(0, 0.01, n))[:, None]
    var = np.full(n, 1e-4)
    xq = np.linspace(-0.8, 0.8, 400)[None, :]
    truth = np.sin(3 * xq[0])
    dgrad = 3 * np.cos(3 * xq[0])

    def mae(a, ref):
        return np.abs(_host(a) - ref).mean()

    # 1. exact GP (reference: VanillaGaussianProcess)
    gp = VanillaGaussianProcessD(VanillaGPSetting(
        kernel_type="rbf", kernel=KernelSetting(x_dim=1, scale=0.3)),
        device=device)
    gp.train(x, y, var)
    r = gp.test(xq)
    print("exact GP      MAE %.2e   mean var %.2e"
          % (mae(r.get_mean(), truth), _host(r.get_variance()).mean()))

    # 2. NIGP with gradient observations (GPIS style)
    grad = 3 * np.cos(3 * x)                           # (x_dim*y_dim, n)
    nig = NoisyInputGaussianProcessD(NoisyInputGPSetting(
        kernel_type="rbf", kernel=KernelSetting(x_dim=1, scale=0.3)),
        device=device)
    nig.train(x, y, mat_grad=grad, var_x=np.full(n, 1e-6), var_y=var,
              var_grad=np.full(n, 1e-4), grad_flag=np.ones(n, bool))
    rn = nig.test(xq, predict_gradient=True)
    print("NIGP+grad     MAE %.2e   grad MAE %.2e"
          % (mae(rn.get_mean(), truth), mae(rn.get_gradient()[0], dgrad)))

    # 3. incremental SPGP over 20 pseudo points, two streamed batches
    sp = SparsePseudoInputGaussianProcessD(
        SpGpSetting(kernel_type="rbf", kernel=KernelSetting(x_dim=1,
                                                            scale=0.3)),
        np.linspace(-1, 1, 20)[None, :], device=device)
    half = n // 2
    sp.update(x[:, :half], y[:half], var[:half])
    sp.update(x[:, half:], y[half:], var[half:])
    print("SPGP (m=20)   MAE %.2e" % mae(sp.test(xq).get_mean(), truth))

    # 4. reduced-rank (Hilbert-space) GP, 64 basis functions
    rr = VanillaGaussianProcess(VanillaGPSetting(
        kernel_type="reduced_rank_rbf",
        kernel=ReducedRankSetting(x_dim=1, scale=0.3, num_basis=[64],
                                  boundary=[2.0], coord_origin=[0.0])),
        device=device)
    rr.train(x, y, var)
    print("RR-GP (64 bf) MAE %.2e" % mae(rr.test(xq).get_mean(), truth))

    # 5. marginal-likelihood scale selection
    best, _, _ = select_scale(x.T, y, var, kernel="rbf", refine=1,
                              device=device)
    tuned = VanillaGaussianProcessD(VanillaGPSetting(
        kernel_type="rbf", kernel=KernelSetting(x_dim=1, scale=best)),
        device=device)
    tuned.train(x, y, var)
    print("NLML scale    %.3f -> MAE %.2e"
          % (best, mae(tuned.test(xq).get_mean(), truth)))

    # 6. NIGP variant: the joint value/gradient NLML
    best_n, _, _ = select_scale_nigp(
        x.T, y, grad.T[:, :, None], np.full(n, 1e-6), var,
        np.full(n, 1e-4), kernel="rbf", refine=1, device=device)
    tuned_n = NoisyInputGaussianProcessD(NoisyInputGPSetting(
        kernel_type="rbf", kernel=KernelSetting(x_dim=1, scale=best_n)),
        device=device)
    tuned_n.train(x, y, mat_grad=grad, var_x=np.full(n, 1e-6), var_y=var,
                  var_grad=np.full(n, 1e-4), grad_flag=np.ones(n, bool))
    rt = tuned_n.test(xq, predict_gradient=True)
    print("NIGP NLML     %.3f -> MAE %.2e   grad MAE %.2e"
          % (best_n, mae(rt.get_mean(), truth),
             mae(rt.get_gradient()[0], dgrad)))

    # 6b. FITC variant: the scale of the fixed-pseudo-point SPGP
    best_s, _, _ = select_scale_spgp(
        np.linspace(-1, 1, 20)[:, None], x.T, y, var, kernel="rbf",
        refine=1, device=device)
    sp_t = SparsePseudoInputGaussianProcessD(
        SpGpSetting(kernel_type="rbf",
                    kernel=KernelSetting(x_dim=1, scale=best_s)),
        np.linspace(-1, 1, 20)[None, :], device=device)
    sp_t.update(x, y, var)
    print("SPGP NLML     %.3f -> MAE %.2e"
          % (best_s, mae(sp_t.test(xq).get_mean(), truth)))

    # 7. scale-mixture kernel: two RBF components at scale and scale/2
    mixgp = VanillaGaussianProcessD(VanillaGPSetting(
        kernel_type="rbf",
        kernel=KernelSetting(x_dim=1, scale=best, scale_mix=0.5,
                             weights=[0.7, 0.3])), device=device)
    mixgp.train(x, y, var)
    print("mixture GP    MAE %.2e" % mae(mixgp.test(xq).get_mean(), truth))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    main(ap.parse_args().device)
