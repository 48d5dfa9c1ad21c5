"""Flag parity of the port's examples with the JAX examples: every
script of examples/ has a port module of its name under
inverseproblemwithdiffusionmodel_tpu_torch/examples/, whose parser
accepts every flag of the JAX script's with the same default. The
parsers are read off `main(argv)` (ArgumentParser.parse_args
intercepted), as tests/test_torch_cli_parity.py reads the scripts'."""
import argparse
import importlib
import os

import pytest

from tests.torch_examples_common import EXAMPLES, load_jax_example

NAMES = sorted(f[:-3] for f in os.listdir(EXAMPLES) if f.endswith(".py"))
# flags the port adds to a JAX example's, each for a reason
PORT_ONLY = {
    "*": {"--device"},                       # the port runs on the card
    "cine_2d_time_quality_matrix": {"--prior_dir"},  # the committed priors
    "continuous_ncsnpp_demo": {"--prior_path"},      # the committed NCSN++
}


class _Parsed(Exception):
    pass


def parser_of(module) -> argparse.ArgumentParser:
    seen = {}
    original = argparse.ArgumentParser.parse_args

    def capture(self, *args, **kwargs):
        seen["parser"] = self
        raise _Parsed()

    argparse.ArgumentParser.parse_args = capture
    try:
        module.main([])
    except _Parsed:
        pass
    finally:
        argparse.ArgumentParser.parse_args = original
    return seen["parser"]


def test_every_example_has_a_port_module():
    assert len(NAMES) == 11
    for name in NAMES:
        importlib.import_module(
            f"inverseproblemwithdiffusionmodel_tpu_torch.examples.{name}")


@pytest.mark.parametrize("name", NAMES)
def test_port_example_keeps_the_jax_flags_and_defaults(name, tmp_path):
    theirs = parser_of(load_jax_example(name, tmp_path))
    ours = parser_of(importlib.import_module(
        f"inverseproblemwithdiffusionmodel_tpu_torch.examples.{name}"))
    t, o = theirs._option_string_actions, ours._option_string_actions
    assert not set(t) - set(o), f"{name}: missing {sorted(set(t) - set(o))}"
    extra = set(o) - set(t) - PORT_ONLY["*"] - PORT_ONLY.get(name, set())
    assert not extra, f"{name}: flags JAX lacks {sorted(extra)}"
    for flag, action in t.items():
        assert o[flag].default == action.default, \
            f"{name} {flag}: {o[flag].default!r} != {action.default!r}"
        assert o[flag].nargs == action.nargs, f"{name} {flag} nargs"
