"""The public names the port had left out, one case each against the JAX
package's: the predictor and corrector registries (sde/sampling.py), the
model registry (models/registry.py), the half-pixel resize (ops/resize.py)
and get_timestamp (utils/misc.py).

And the package-level names: every name a JAX package __init__ exports can
be imported from the port's counterpart, as the same object as the port
submodule's. The names are read from the JAX __init__ files' ASTs: what a
relative `from .sub import name` binds, and what the file itself defines
or assigns (`__version__`, `__all__` among them); imports of outside
modules (`jax.numpy as jnp`, `typing`) are not exports. A JAX `__all__`
must be inside the port's `__all__`, and `__version__` equal."""
import ast
import datetime
import importlib
import os
import re
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from inverseproblemwithdiffusionmodel_tpu import ops as jops
from inverseproblemwithdiffusionmodel_tpu.models import registry as jreg
from inverseproblemwithdiffusionmodel_tpu.sde import sampling as jsampling
from inverseproblemwithdiffusionmodel_tpu.utils import misc as jmisc
from inverseproblemwithdiffusionmodel_tpu_torch import ops, sde
from inverseproblemwithdiffusionmodel_tpu_torch.models import registry
from inverseproblemwithdiffusionmodel_tpu_torch.scripts import _common
from inverseproblemwithdiffusionmodel_tpu_torch.sde import sampling
from inverseproblemwithdiffusionmodel_tpu_torch.utils import misc


def _registry(register, get, table, base):
    """A class registered bare (under its class name) and with name=, found
    by name; the table left as it was."""
    class Probe(base):
        pass

    class Named(base):
        pass

    try:
        assert register(Probe) is Probe
        assert register(name="probe_named")(Named) is Named
        assert get("Probe") is Probe and get("probe_named") is Named
    finally:
        table.pop("Probe", None)
        table.pop("probe_named", None)
    return Probe, Named


def check_register_predictor():
    for reg, get, table, base in (
            (jsampling.register_predictor, jsampling.get_predictor,
             jsampling._PREDICTORS, jsampling.Predictor),
            (sampling.register_predictor, sampling.get_predictor,
             sampling._PREDICTORS, sampling.Predictor)):
        _registry(reg, get, table, base)
        with pytest.raises(KeyError):
            get("no_such_predictor")
    assert sde.register_predictor is sampling.register_predictor
    assert set(jsampling._PREDICTORS) == set(sampling._PREDICTORS)


def check_register_corrector():
    for reg, get, table, base in (
            (jsampling.register_corrector, jsampling.get_corrector,
             jsampling._CORRECTORS, jsampling.Corrector),
            (sampling.register_corrector, sampling.get_corrector,
             sampling._CORRECTORS, sampling.Corrector)):
        _registry(reg, get, table, base)
        with pytest.raises(KeyError):
            get("no_such_corrector")
    assert sde.register_corrector is sampling.register_corrector
    assert set(jsampling._CORRECTORS) == set(sampling._CORRECTORS)


def check_register_model():
    for reg, table, base in ((jreg.register_model, jreg._MODELS, object),
                             (registry.register_model, registry._MODELS,
                              torch.nn.Module)):
        probe, named = _registry(reg, lambda n: table[n], table, base)
        reg(probe)
        try:
            for again in (lambda: reg(probe),
                          lambda: reg(name="Probe")(named)):
                with pytest.raises(ValueError,
                                   match="Already registered model with "
                                         "name: Probe"):
                    again()
        finally:
            table.pop("Probe")
    assert registry.get_model("ncsnv2_deepest") is not None


def check_resize_half_pixel():
    assert ops.resize_half_pixel is not None and "resize_half_pixel" in \
        dir(jops)
    rs = np.random.RandomState(0)
    for shape, sizes, axes in (((2, 5, 7), (10, 3), (1, 2)),
                               ((3, 8, 4, 2), (3, 9), (1, 2)),
                               ((4, 6), (1,), (1,)), ((1, 16, 16, 1), (4, 4),
                                                      (1, 2))):
        x = rs.randn(*shape).astype(np.float32)
        want = np.asarray(jops.resize_half_pixel(jnp.asarray(x), sizes,
                                                 axes))
        got = ops.resize_half_pixel(torch.from_numpy(x), sizes, axes)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # it is torch's linear resize with half-pixel centres
    x = torch.from_numpy(rs.randn(2, 3, 6, 5).astype(np.float32))
    ref = F.interpolate(x, size=(9, 4), mode="bilinear",
                        align_corners=False)
    torch.testing.assert_close(ops.resize_half_pixel(x, (9, 4)), ref,
                               rtol=1e-5, atol=1e-5)


def check_get_timestamp():
    form = r"\d{4}_\d{2}_\d{2}_\d{2}_\d{2}_\d{2}_\d{6}"
    ours, theirs = misc.get_timestamp(), jmisc.get_timestamp()
    assert re.fullmatch(form, ours) and re.fullmatch(form, theirs)
    parse = lambda s: datetime.datetime.strptime(s, "%Y_%m_%d_%H_%M_%S_%f")
    assert abs((parse(theirs) - parse(ours)).total_seconds()) < 60
    assert _common.get_timestamp is misc.get_timestamp


CHECKS = {"register_predictor": check_register_predictor,
          "register_corrector": check_register_corrector,
          "register_model": check_register_model,
          "resize_half_pixel": check_resize_half_pixel,
          "get_timestamp": check_get_timestamp}


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_public_name_is_jax(name):
    CHECKS[name]()


# -- package-level names ----------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "inverseproblemwithdiffusionmodel_tpu"
PORT_PKG = "inverseproblemwithdiffusionmodel_tpu_torch"

# names no port package exports, each with its reason (none at present:
# the port-only differences are below package level, ROADMAP "What is
# left, by file")
EXCEPTIONS = {}


def _init_files():
    out = []
    for root, _, files in sorted(os.walk(os.path.join(ROOT, JAX_PKG))):
        if "__init__.py" in files and "__pycache__" not in root:
            out.append(os.path.relpath(root, os.path.join(ROOT, JAX_PKG)))
    return sorted(out)


def _exports(path):
    """{name: submodule or None} of what the __init__ at `path` exports:
    a relative import's names with their submodule, its own definitions
    and assignments with None."""
    tree = ast.parse(open(path).read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            for alias in node.names:
                out[alias.asname or alias.name] = node.module
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = None
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    out[target.id] = None
    return out


def _module_name(pkg, rel):
    return pkg if rel == "." else f"{pkg}.{rel.replace(os.sep, '.')}"


@pytest.mark.parametrize("rel", _init_files())
def test_port_package_exports_the_jax_names(rel):
    exports = _exports(os.path.join(ROOT, JAX_PKG, rel, "__init__.py"))
    port = importlib.import_module(_module_name(PORT_PKG, rel))
    jax_all = None
    missing, different = [], []
    for name, sub in sorted(exports.items()):
        if (rel, name) in EXCEPTIONS:
            continue
        if name == "__all__":
            jax_all = ast.literal_eval(next(
                node.value for node in ast.parse(open(os.path.join(
                    ROOT, JAX_PKG, rel, "__init__.py")).read()).body
                if isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "__all__"
                        for t in node.targets)))
            continue
        if not hasattr(port, name):
            missing.append(name)
            continue
        if sub is not None:
            try:
                submodule = importlib.import_module(
                    f"{_module_name(PORT_PKG, rel)}.{sub}")
            except ImportError:
                continue      # the port keeps it in another module
            if hasattr(submodule, name) and \
                    getattr(port, name) is not getattr(submodule, name):
                different.append(name)
    assert not missing, f"{rel}: the port does not export {missing}"
    assert not different, f"{rel}: not the submodule's objects: {different}"
    if jax_all is not None:
        assert set(jax_all) <= set(getattr(port, "__all__", ())), (
            f"{rel}: __all__ lacks "
            f"{sorted(set(jax_all) - set(getattr(port, '__all__', ())))}")
    if "__version__" in exports:
        jax_version = ast.literal_eval(next(
            node.value for node in ast.parse(open(os.path.join(
                ROOT, JAX_PKG, rel, "__init__.py")).read()).body
            if isinstance(node, ast.Assign)
            and any(getattr(t, "id", None) == "__version__"
                    for t in node.targets)))
        assert port.__version__ == jax_version


def test_exports_keep_the_optional_imports_lazy():
    """Importing every port package loads no Pillow, matplotlib or
    tensorboard (they stay inside the functions that use them)."""
    mods = [_module_name(PORT_PKG, rel) for rel in _init_files()]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "print([m for m in ('PIL', 'matplotlib', 'tensorboard') "
              "if m in sys.modules])")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_samplers_lazy_names_are_the_submodule_objects():
    """samplers' ald_pair names load on first use (a circular import
    otherwise), and are ald_pair's own objects."""
    from inverseproblemwithdiffusionmodel_tpu_torch import samplers
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers import ald_pair
    for name in samplers._ALD_PAIR:
        assert getattr(samplers, name) is getattr(ald_pair, name)
        assert name in dir(samplers)
    with pytest.raises(AttributeError):
        samplers.no_such_name
