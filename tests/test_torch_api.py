"""The PyTorch port's reference-compatible API surface
(``erl_gaussian_process_tpu_torch/api.py`` and ``api.pyi``) against the JAX
package's: tests/test_api.py's four cases against the port's ``api``, and
every name of JAX's ``api.__all__`` and ``api.pyi`` present in the port's,
with each public member of each JAX class."""

import ast
import os

import numpy as np
import torch

from erl_gaussian_process_tpu import api as japi
from erl_gaussian_process_tpu_torch import api

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_all_reference_exports_present():
    for name in [
        "VanillaGaussianProcessD", "VanillaGaussianProcessF",
        "NoisyInputGaussianProcessD", "NoisyInputGaussianProcessF",
        "MappingD", "MappingF", "MappingType",
        "LidarGaussianProcess2Dd", "LidarGaussianProcess2Df",
        "RangeSensorGaussianProcess3Dd", "RangeSensorGaussianProcess3Df",
    ]:
        assert hasattr(api, name), name
        assert name in api.__all__, name


def test_dtype_variants_pin_dtype():
    d = api.VanillaGaussianProcessD(device=CPU)
    f = api.VanillaGaussianProcessF(device=CPU)
    assert d.dtype == np.float64 and f.dtype == np.float32
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (1, 30))
    y = np.sin(2 * x[0])[:, None]
    for gp, dt in [(d, np.float64), (f, np.float32)]:
        gp.train(x, y, np.full(30, 1e-4))
        res = gp.test(np.linspace(-0.5, 0.5, 7)[None, :])
        assert res.get_mean().dtype == dt
        assert isinstance(gp, api.VanillaGaussianProcess)
    # the port's D variant predicts what JAX's does
    jd = japi.VanillaGaussianProcessD()
    jd.train(x, y, np.full(30, 1e-4))
    q = np.linspace(-0.5, 0.5, 7)[None, :]
    np.testing.assert_allclose(np.asarray(d.test(q).get_mean()),
                               np.asarray(jd.test(q).get_mean()),
                               rtol=1e-10, atol=1e-12)


def test_mapping_type_enum_names():
    for entry in ["IDENTITY", "INVERSE", "INVERSE_SQRT", "EXP", "LOG",
                  "TANH", "SIGMOID"]:
        assert hasattr(api.MappingType, entry), entry
    m = api.MappingD(api.Mapping.Setting(type=api.MappingType.INVERSE_SQRT))
    x = np.asarray([4.0])
    np.testing.assert_allclose(np.asarray(m.map(x)), [0.5])
    np.testing.assert_allclose(np.asarray(m.inv(m.map(x))), x)


def test_unbound_reference_classes_also_exported():
    pseudo = np.linspace(0, 1, 16)[None, :]
    gp = api.SparsePseudoInputGaussianProcessF(None, pseudo, device=CPU)
    assert gp.dtype == torch.float32
    assert tuple(gp.pseudo_points.shape) == (1, 16)
    assert api.SpGpOccupancyMapD.dtype_ == np.float64


def _pyi_names(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.ImportFrom):
            names.update(a.asname for a in node.names if a.asname)
    return names - {"__all__"}


def test_surface_covers_jax_api_and_members():
    """Every name of JAX's ``api.__all__`` and ``api.pyi`` is in the
    port's (its ``__all__`` and its ``api.pyi``), and every public member
    of each JAX class is a member of the port's class of that name."""
    assert set(japi.__all__) <= set(api.__all__)
    jpyi = _pyi_names(os.path.join(REPO, "erl_gaussian_process_tpu",
                                   "api.pyi"))
    tpyi = _pyi_names(os.path.join(REPO, "erl_gaussian_process_tpu_torch",
                                   "api.pyi"))
    assert jpyi <= tpyi, jpyi - tpyi
    missing = []
    for name in sorted(set(japi.__all__) | jpyi):
        jobj, tobj = getattr(japi, name), getattr(api, name)
        if not isinstance(jobj, type):
            continue
        for member in dir(jobj):
            if not member.startswith("_") and not hasattr(tobj, member):
                missing.append(f"{name}.{member}")
    assert not missing, missing
