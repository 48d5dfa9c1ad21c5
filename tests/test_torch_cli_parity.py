"""CLI flag parity with the JAX package: every script under the JAX
package's scripts/ has a same-named script in the port, and the port's
parser accepts every flag (and alias) the JAX script's parser defines, so
a migrating user's job scripts keep working. The parsers are read off
`main(argv)` itself: ArgumentParser.parse_args is intercepted, so the
flags compared are those each script really defines, shared helpers
(add_common_args) included."""
import argparse
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPTS = os.path.join(ROOT, "inverseproblemwithdiffusionmodel_tpu",
                           "scripts")
SCRIPTS = sorted(f[:-3] for f in os.listdir(JAX_SCRIPTS)
                 if f.endswith(".py") and not f.startswith("_"))
# Flags the port accepts beyond the JAX script's: its device choice.
PORT_ONLY = {"--device"}


class _Parsed(Exception):
    pass


def parser_flags(module_name: str) -> set:
    """The option strings of the parser `main([])` builds."""
    module = importlib.import_module(module_name)
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
    assert "parser" in seen, f"{module_name}.main built no parser"
    return set(seen["parser"]._option_string_actions)


def test_every_jax_script_has_a_port_script():
    port = os.path.join(ROOT, "inverseproblemwithdiffusionmodel_tpu_torch",
                        "scripts")
    missing = [s for s in SCRIPTS
               if not os.path.isfile(os.path.join(port, f"{s}.py"))]
    assert not missing, f"no port script for {missing}"
    assert len(SCRIPTS) == 23


@pytest.mark.parametrize("script", SCRIPTS)
def test_port_script_accepts_every_jax_flag(script):
    theirs = parser_flags(f"inverseproblemwithdiffusionmodel_tpu.scripts."
                          f"{script}")
    ours = parser_flags(f"inverseproblemwithdiffusionmodel_tpu_torch."
                        f"scripts.{script}")
    assert not theirs - ours, f"flags the port lacks: {sorted(theirs - ours)}"
    assert ours - theirs <= PORT_ONLY | {"-h", "--help"}, sorted(
        ours - theirs)
