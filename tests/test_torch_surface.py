"""The port's public surface against the JAX package's, module by module.

For every module of the JAX package (walked with ``pkgutil``), the port's
module of the same dotted path (an ``ops`` module: its counterpart in
``OPS_MODULES``) must have

- every public name the JAX module defines at its top level or lists in
  ``__all__``;
- for each such function, and each method, classmethod and staticmethod
  of each such class (nested classes too), every parameter name of the
  JAX signature, and each positional parameter at JAX's position;
- for each dataclass and NamedTuple, the same fields in the same order.

A parameter that the port's function takes through ``**kwargs`` (and
``*args`` where JAX passes it positionally) counts as taken: the function
it forwards to is checked on its own. The only exceptions are
``DEPARTURES``, each with its reason; every entry must be needed. One
test case per JAX module; the walk runs on one torch thread."""

import ast
import dataclasses
import importlib
import inspect
import pkgutil

import pytest
import torch

import erl_gaussian_process_tpu as jax_package

JAX = jax_package.__name__
PORT = "erl_gaussian_process_tpu_torch"

# The JAX package's ``ops`` modules hold its Pallas kernels under TPU names;
# each maps to the port's module that does its work.
OPS_MODULES = {
    "ops": "ops",
    "ops.pallas_gram": "ops.gram",
    "ops.pallas_fitc": "ops.fitc",
    "ops.pallas_bank": "ops.bank",
    "ops.pallas_chol": "ops.chol",
    "ops.pallas_trsv": "ops.trsv",
    "ops.blocked_solve": "models.gp_core",
    "ops.vma": "parallel.mesh",
}

_ROADMAP = "ROADMAP.md, Queue 3, 'Deliberate API departures'"
TPU_NAME = ("a Pallas entry or TPU dispatch switch: the port's kernels are "
            "in ops/{gram,fitc,bank,chol,trsv}.py and gp_core.whiten, "
            f"which run on every CUDA tensor ({_ROADMAP})")
XLA_SWITCH = ("an XLA matmul-precision switch: the port is true FP32 by "
              f"default, gp_core.use_full_fp32_matmul ({_ROADMAP})")
KEY = ("a JAX PRNG key (and step): the port takes a torch.Generator, a "
       f"seed or the sampler's fractions u ({_ROADMAP})")
NO_PALLAS = f"the Pallas kernel switch use_pallas= is dropped ({_ROADMAP})"
PLATFORMS = ("jax.export's platforms=: an artifact of the port is for one "
             f"device ({_ROADMAP})")
ARG_SPECS = ("torch.export takes example arguments, not shape specs: "
             f"export_fn(fn, *example_args) ({_ROADMAP})")
TILE = ("the CUDA Cholesky's tile is fixed by its kernel (ops.chol.TILE = "
        f"64), not a Pallas block choice ({_ROADMAP})")
FAM = ("the family is name=, as in every kernel wrapper of the port "
       f"({_ROADMAP})")
DINV = ("the extra trailing field dinv holds the blocked Cholesky's "
        "diagonal-tile inverses for gp_core.whiten; it defaults to None and "
        f"is not checkpointed ({_ROADMAP})")

# (JAX module that defines the object, qualified name) -> reason; with a
# third item: the parameter of that function (or "fields" of that class)
# that the port does not take
DEPARTURES = {
    ("ops.pallas_gram", "pallas_gram_enabled"): TPU_NAME,
    ("ops.pallas_gram", "pallas_cross_gram"): TPU_NAME,
    ("ops.pallas_fitc", "pallas_fitc_enabled"): TPU_NAME,
    ("ops.pallas_fitc", "pallas_fitc_update"): TPU_NAME,
    ("ops.pallas_bank", "pallas_bank_applies"): TPU_NAME,
    ("ops.pallas_bank", "pallas_bank_enabled"): TPU_NAME,
    ("ops.pallas_bank", "bank_fit_fused"): TPU_NAME,
    ("ops.pallas_bank", "bank_cholesky_solve_fused"): TPU_NAME,
    ("ops.pallas_chol", "pallas_chol_enabled"): TPU_NAME,
    ("ops.pallas_chol", "pallas_chol_gram_enabled"): TPU_NAME,
    ("ops.pallas_chol", "pallas_chol_joint_enabled"): TPU_NAME,
    ("ops.pallas_trsv", "pallas_trsv_enabled"): TPU_NAME,
    ("ops.blocked_solve", "blocked_whiten_enabled"): TPU_NAME,
    ("ops.blocked_solve", "blocked_solve_lower"): TPU_NAME,
    ("ops.vma", "io_vma"): ("shard_map's varying-manual-axes annotation: "
                            "the port's mesh calls torch.distributed "
                            f"itself ({_ROADMAP})"),
    ("ops.pallas_chol", "chol_blocked", "tile"): TILE,
    ("ops.pallas_chol", "chol_blocked_gram", "tile"): TILE,
    ("ops.pallas_chol", "chol_blocked_gram_joint", "tile"): TILE,
    ("models.gp_core", "f32_matmul"): XLA_SWITCH,
    ("models.gp_core", "matmul_precision"): XLA_SWITCH,
    ("utils.timing", "warn_if_x64_disabled"): XLA_SWITCH,
    ("geometry.occupancy_dataset", "generate_dataset_fixed", "key"): KEY,
    ("models.spgp_occupancy_map", "sample_pose", "key"): KEY,
    ("models.spgp_occupancy_map", "sample_pose", "step"): KEY,
    ("models.spgp_occupancy_map", "update_step", "key"): KEY,
    ("models.spgp_occupancy_map", "update_step", "step"): KEY,
    ("models.batch_gp", "bank_fit_core", "use_pallas"): NO_PALLAS,
    ("models.sparse_pseudo_input_gp", "spgp_update", "use_pallas"):
        NO_PALLAS,
    ("utils.deploy", "export_fn", "arg_specs"): ARG_SPECS,
    ("utils.deploy", "export_fn", "platforms"): PLATFORMS,
    ("utils.deploy", "export_map_predict_step", "platforms"): PLATFORMS,
    ("utils.deploy", "export_map_update_step", "platforms"): PLATFORMS,
    ("models.vanilla_gp", "VanillaGPState", "fields"): DINV,
    ("models.noisy_input_gp", "NoisyInputGPState", "fields"): DINV,
}

# (module, qualified name, JAX's parameter) -> (the port's name for it at
# the same position, reason)
RENAMED = {
    ("ops.pallas_chol", "chol_blocked_gram", "fam"): ("name", FAM),
    ("ops.pallas_chol", "chol_blocked_gram_joint", "fam"): ("name", FAM),
    ("models.spgp_occupancy_map", "update_batch_steps", "key"): ("seed",
                                                                 KEY),
}


def jax_modules() -> list:
    """Every module of the JAX package, relative to it ("" is the package
    itself)."""
    return [""] + sorted(m.name[len(JAX) + 1:] for m in pkgutil.walk_packages(
        jax_package.__path__, JAX + "."))


def port_module_name(rel: str) -> str:
    if rel.split(".")[0] == "ops":
        rel = OPS_MODULES[rel]
    return f"{PORT}.{rel}" if rel else PORT


def _rel(module_name: str) -> str:
    return module_name[len(JAX) + 1:]


def defined_names(module) -> list:
    """The public names a module assigns, defines or imports at its top
    level and lists in ``__all__`` (imports count only when listed)."""
    tree = ast.parse(inspect.getsource(module))
    names = set(getattr(module, "__all__", ()))
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
    return sorted(n for n in names if not n.startswith("_"))


class Gaps:
    """The gaps found, and the departures that excused one."""

    def __init__(self):
        self.missing, self.used = [], set()

    @staticmethod
    def _key(obj, *item) -> tuple:
        return (_rel(getattr(obj, "__module__", "") or ""),
                getattr(obj, "__qualname__", ""), *item)

    def excused(self, obj, *item) -> bool:
        key = self._key(obj, *item)
        if key in DEPARTURES:
            self.used.add(key)
            return True
        return False

    def port_name(self, fn, param: str) -> str:
        """The port's name of ``fn``'s parameter ``param``."""
        key = self._key(fn, param)
        if key in RENAMED:
            self.used.add(key)
            return RENAMED[key][0]
        return param


def _raw(cls, name):
    """A class attribute as defined: the function of a static- or
    classmethod, else the attribute."""
    v = inspect.getattr_static(cls, name)
    return v.__func__ if isinstance(v, (staticmethod, classmethod)) else v


def _signature(fn):
    try:
        return inspect.signature(fn)
    except (TypeError, ValueError):
        return None


def check_params(jfn, tfn, where: str, gaps: Gaps, owner=None) -> None:
    """Every parameter of ``jfn`` is one of ``tfn``'s, at the same position
    when JAX passes it positionally. ``owner``: the object whose departures
    apply (the function itself, or the class of a constructor)."""
    owner = jfn if owner is None else owner
    js, ts = _signature(jfn), _signature(tfn)
    if js is None or ts is None:
        return
    P = inspect.Parameter
    tparams = list(ts.parameters.values())
    # the port's parameters by name -> their position when positional
    tnames = {p.name: i if p.kind in (P.POSITIONAL_ONLY,
                                      P.POSITIONAL_OR_KEYWORD) else None
              for i, p in enumerate(tparams)
              if p.kind not in (P.VAR_POSITIONAL, P.VAR_KEYWORD)}
    tkinds = {p.kind for p in tparams}
    i = 0      # the position among the parameters that do not depart
    for p in js.parameters.values():
        if p.name not in ("self", "cls") and gaps.excused(owner, p.name):
            continue
        name = gaps.port_name(owner, p.name)
        if p.kind in (P.VAR_POSITIONAL, P.VAR_KEYWORD):
            ok = p.kind in tkinds
        elif name in tnames:
            ok = p.kind != P.POSITIONAL_OR_KEYWORD or tnames[name] == i \
                or P.VAR_POSITIONAL in tkinds
        else:
            ok = P.VAR_KEYWORD in tkinds
        if not ok:
            gaps.missing.append(f"{where}({p.name})")
        i += 1


def _fields(cls):
    if dataclasses.is_dataclass(cls):
        return [f.name for f in dataclasses.fields(cls)]
    if isinstance(cls, type) and issubclass(cls, tuple) and \
            hasattr(cls, "_fields"):
        return list(cls._fields)
    return None


def check_class(jcls, tcls, where: str, gaps: Gaps) -> None:
    jf, tf = _fields(jcls), _fields(tcls)
    if jf is not None and jf != tf and not gaps.excused(jcls, "fields"):
        gaps.missing.append(f"{where} fields {jf} != {tf}")
    check_params(jcls.__init__, tcls.__init__, f"{where}.__init__", gaps,
                 owner=jcls)
    for name, value in vars(jcls).items():
        if name.startswith("_") or (jf and name in jf):
            continue
        member = f"{where}.{name}"
        if not hasattr(tcls, name):
            gaps.missing.append(member)
            continue
        jraw, traw = _raw(jcls, name), _raw(tcls, name)
        if inspect.isclass(jraw):
            if jraw.__qualname__.startswith(jcls.__qualname__ + "."):
                check_class(jraw, traw, member, gaps)
        elif callable(jraw) and callable(traw):
            check_params(jraw, traw, member, gaps)


def module_gaps(rel: str) -> Gaps:
    jmod = importlib.import_module(f"{JAX}.{rel}" if rel else JAX)
    tname = port_module_name(rel)
    gaps = Gaps()
    try:
        tmod = importlib.import_module(tname)
    except ModuleNotFoundError:
        gaps.missing.append(f"module {tname}")
        return gaps
    for name in defined_names(jmod):
        jobj = getattr(jmod, name)
        if gaps.excused(jobj):
            continue
        where = f"{tname}.{name}"
        if not hasattr(tmod, name):
            gaps.missing.append(where)
            continue
        tobj = getattr(tmod, name)
        if inspect.isclass(jobj) and inspect.isclass(tobj):
            check_class(jobj, tobj, where, gaps)
        elif callable(jobj) and callable(tobj):     # jitted ones too
            check_params(jobj, tobj, where, gaps)
    return gaps


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("rel", jax_modules())
def test_module_surface(rel):
    assert module_gaps(rel).missing == []


def test_every_departure_is_needed():
    used = set()
    for rel in jax_modules():
        used |= module_gaps(rel).used
    assert (set(DEPARTURES) | set(RENAMED)) - used == set()


def test_ops_map_covers_every_jax_ops_module():
    ops = {rel for rel in jax_modules() if rel.split(".")[0] == "ops"}
    assert ops == set(OPS_MODULES)
    for target in OPS_MODULES.values():
        importlib.import_module(f"{PORT}.{target}")
