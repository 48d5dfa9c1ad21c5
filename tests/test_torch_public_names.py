"""The public names the port had left out, one case each against the JAX
package's: the predictor and corrector registries (sde/sampling.py), the
model registry (models/registry.py), the half-pixel resize (ops/resize.py)
and get_timestamp (utils/misc.py)."""
import datetime
import re

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
