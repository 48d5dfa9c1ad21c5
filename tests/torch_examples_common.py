"""Helpers of the tests that hold the port's examples to the JAX package's
(tests/test_torch_examples_*.py).

The JAX examples are scripts under examples/, run here as they are: each
is imported from its file with HOME pointed at a temporary directory
(they set a persistent compilation cache under ~/.cache at import), and
JAX's cache settings are put back right after. `Recorder` wraps a
module's factories on either side and keeps each call's arguments (and,
for a factory that returns a callable, that callable's arguments), so a
test compares the numbers both examples hand the samplers, optimizers
and trainers.
"""
import ast
import dataclasses
import functools
import importlib.util
import os
import shutil
import sys

import jax
import numpy as np
import torch

from inverseproblemwithdiffusionmodel_tpu_torch.examples import (
    cine_2d_time_quality_matrix as pmatrix)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
ARG_TOL = 1e-6          # rel max of a recorded array argument
ROW_TOL = 3e-2          # rel of a MAP / TV row, the same prior on both sides

_CACHE_OPTIONS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs",
                  "jax_persistent_cache_min_entry_size_bytes")


def load_jax_example(name, tmp_home):
    """examples/<name>.py imported as a module, HOME pointed at tmp_home
    while it runs its import-time cache settings; JAX's cache options are
    restored after them."""
    key = f"jax_example_{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = os.path.join(EXAMPLES, f"{name}.py")
    # the JAX package's modules first, under the real HOME (some read it
    # at import, e.g. the data root)
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module.startswith("inverseproblemwithdiffusionmodel_tpu"):
            importlib.import_module(node.module)
    saved = {o: getattr(jax.config, o) for o in _CACHE_OPTIONS}
    home = os.environ.get("HOME")
    os.environ["HOME"] = str(tmp_home)
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    try:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    finally:
        if home is None:
            os.environ.pop("HOME", None)
        else:
            os.environ["HOME"] = home
        for option, value in saved.items():
            jax.config.update(option, value)
    return mod


class NoJit:
    """A stand-in for an example module's `jax` whose `jit` returns the
    function itself: the example's jitted closures then run eagerly, so
    the samplers inside see concrete arguments that a Recorder can keep
    (the samplers compile their own loops as they always do)."""

    def __getattr__(self, name):
        if name == "jit":
            return lambda fn=None, **kw: (fn if fn is not None
                                          else (lambda f: f))
        return getattr(jax, name)


class Recorder:
    """recorder.wrap(module, "name") replaces module.name by a wrapper
    that keeps every call's (args, kwargs) under calls["name"]; with
    returns=True the callable it returns is wrapped too, its calls kept
    under calls["name()"]. Use as a context manager (the originals come
    back on exit)."""

    def __init__(self):
        self.calls = {}
        self._undo = []

    def wrap(self, module, name, returns=False, key=None):
        orig = getattr(module, name)
        key = key or name

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            self.calls.setdefault(key, []).append((args, kwargs))
            out = orig(*args, **kwargs)
            if returns and callable(out):
                inner = out

                def called(*a, **k):
                    self.calls.setdefault(key + "()", []).append((a, k))
                    return inner(*a, **k)
                return called
            return out

        setattr(module, name, wrapper)
        self._undo.append((module, name, orig))
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)


def numeric(x):
    """The numbers in x: arrays and tensors as float64 numpy, dataclasses
    (configs, operators, proximals; JAX structs are dataclasses too) as
    dicts of their numeric fields, Configs as dicts, sequences
    elementwise; None for what holds no number (functions, modules)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    if isinstance(x, (np.ndarray, np.generic)) or type(x).__module__.startswith(
            ("jax", "jaxlib")):
        try:
            return np.asarray(x, np.float64)
        except (TypeError, ValueError):
            return None
    if isinstance(x, (bool, int, float, str)) or x is None:
        return x
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        out = {f.name: numeric(getattr(x, f.name))
               for f in dataclasses.fields(x)}
        return {k: v for k, v in out.items() if v is not None}
    if hasattr(x, "to_dict"):
        return x.to_dict()
    if isinstance(x, (list, tuple)):
        return [numeric(v) for v in x]
    return None


def assert_same(port, ref, where, tol=ARG_TOL):
    """port's numbers equal ref's: arrays within `tol` of ref's largest
    magnitude, scalars within tol relative, everything else equal."""
    p, r = numeric(port), numeric(ref)
    _same(p, r, where, tol)


def _same(p, r, where, tol):
    if isinstance(r, np.ndarray) or isinstance(p, np.ndarray):
        p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
        assert p.shape == r.shape, f"{where}: shape {p.shape} != {r.shape}"
        scale = max(float(np.abs(r).max()) if r.size else 0.0, 1e-30)
        err = float(np.abs(p - r).max()) if r.size else 0.0
        assert err <= tol * scale, f"{where}: max |diff| {err} > {tol} x " \
                                   f"{scale}"
    elif isinstance(r, dict):
        common = [k for k in r if k in p]
        assert common or not r, f"{where}: no field in common"
        for k in common:
            _same(p[k], r[k], f"{where}.{k}", tol)
    elif isinstance(r, list):
        assert len(p) == len(r), f"{where}: {len(p)} entries != {len(r)}"
        for i, (a, b) in enumerate(zip(p, r)):
            _same(a, b, f"{where}[{i}]", tol)
    elif isinstance(r, float) and not isinstance(r, bool):
        assert abs(p - r) <= tol * max(abs(r), 1e-30), f"{where}: {p} != {r}"
    else:
        assert p == r, f"{where}: {p!r} != {r!r}"


def same_call(port_call, jax_call, where, positions=(), keywords=(),
              tol=ARG_TOL):
    """The recorded calls' numeric arguments agree: `positions` are
    (port index, JAX index) pairs of positional arguments, `keywords`
    names keyword arguments both pass."""
    (pa, pk), (ja, jk) = port_call, jax_call
    for ip, ij in positions:
        assert_same(pa[ip], ja[ij], f"{where} arg {ij}", tol)
    for name in keywords:
        assert_same(pk[name], jk[name], f"{where} {name}=", tol)


def rows_close(port, ref, names, tol=ROW_TOL, where="row"):
    """results rows (name -> {"nrmse", "ssim"}) within rel `tol`."""
    for name in names:
        for metric in ("nrmse", "ssim"):
            a, b = port[name][metric], ref[name][metric]
            assert abs(a - b) <= tol * abs(b), \
                f"{where} {name} {metric}: port {a}, JAX {b}"


# -- the cine matrix at a tiny setting --------------------------------------

MATRIX_ARGS = ["--size", "16", "--T", "4", "--win", "2", "--ngf_s", "8",
               "--ngf_t", "8", "--n_train", "4", "--steps_s", "2",
               "--steps_t", "2", "--levels", "4", "--levels_t", "3",
               "--n_steps_each", "1", "--chains", "2", "--map_iters", "6",
               "--map_lamdas", "0.3", "--tv_regs", "0.03", "0.1", "--Rs", "8",
               "--ald_lamdas", "3", "--lr_scaleds", "3e4", "--only",
               "ALD,MAP,TV", "--random_shift", "--tube_shift_aug", "1",
               "--filter_t", "0.005"]


def port_priors(tmp, name="port_priors"):
    """Cine priors at MATRIX_ARGS' geometry trained by the port (Flax
    files: the JAX example loads them too)."""
    prior_dir = tmp / name
    pmatrix.main(MATRIX_ARGS + ["--out", str(tmp / "port_train"),
                                "--device", "cpu", "--prior_dir",
                                str(prior_dir), "--only", "TV"])
    return prior_dir


def run_both(tmp, only, jax_names, port_names, prior_dir=None):
    """The JAX script (into tmp/jax; on copies of `prior_dir`'s files
    where given, else training its own), then the port (into tmp/port, on
    the same prior files), `only` the variants given; each side's
    factories in `*_names` ((module attribute, returns a callable)) are
    recorded."""
    jm = load_jax_example("cine_2d_time_quality_matrix", tmp / "home")
    jout, pout = tmp / "jax", tmp / "port"
    if prior_dir is not None:
        shutil.copytree(prior_dir, jout / "priors")
    args = [a if a != "ALD,MAP,TV" else only for a in MATRIX_ARGS]
    real_jax = jm.jax
    jm.jax = NoJit()
    try:
        with Recorder() as jrec:
            for name, returns in jax_names:
                jrec.wrap(jm, name, returns=returns)
            jres = jm.main(args + ["--out", str(jout)])
    finally:
        jm.jax = real_jax
    with Recorder() as prec:
        for module, name, returns in port_names:
            prec.wrap(module, name, returns=returns)
        pres = pmatrix.main(args + ["--out", str(pout), "--device", "cpu",
                                    "--prior_dir", str(jout / "priors")])
    return dict(jres=jres, pres=pres, jrec=jrec.calls, prec=prec.calls,
                jout=jout, pout=pout)
