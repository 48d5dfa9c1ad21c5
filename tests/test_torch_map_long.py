"""The long-run readings behind chip_smoke.py's map_tv gates: the port's
complex and pair forms of MAP and TV after the config's 200 iterations,
on the problem of tests/test_torch_map_tv.py (16 px, the tiny NCSNv2, 2
coils), and a control that the bounds must reject.
"""
import numpy as np
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu_torch.config import Config
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsnv2 import NCSNv2
from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
    make_score_fn)
from inverseproblemwithdiffusionmodel_tpu_torch.samplers import (
    map_opt, map_pair)
from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
    sigma_ladder)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    seeded_weights)
from tests.test_torch_map_tv import (
    LR, TINY, image, operators, pair_operators, parts)

torch.set_num_threads(1)


# After the config's 200 iterations with b1 = b2 = 0.5, two float32
# computations of the same MAP or TV problem part by rounding alone: Adam
# is nearly sign descent and hovers about the optimum, which side of it
# rounding decides. These bounds hold that parting (read here at 16 px:
# MAP 5.95e-03 rel L2, 1.5 % of the elements more than 5 lr apart; TV
# 3.72e-03 and 0.1 %), and a real difference, the prior or TV weight
# doubled, breaks them. chip_smoke.py's map_tv phase gates the full-width
# problem on the card at the same bounds, with the same control.
LONG_ITERS = 200
LONG_REL = 3e-2          # rel L2 of the two forms' iterates
LONG_FAR_SHARE = 0.25    # share of elements more than 5 lr apart


def parting(a, b, lr=LR):
    """(rel L2, share more than lr apart, share more than 5 lr apart)."""
    a, b = parts(a).astype(np.float64), parts(b).astype(np.float64)
    d = np.abs(a - b)
    return (float(np.linalg.norm(a - b) / np.linalg.norm(b)),
            float(np.mean(d > lr)), float(np.mean(d > 5 * lr)))


def within(reading):
    return reading[0] <= LONG_REL and reading[2] <= LONG_FAR_SHARE


@pytest.mark.parametrize("kind", ["map", "tv"])
def test_long_runs_part_by_rounding_alone(kind):
    """The complex and pair forms after 200 iterations stay within the
    bounds; the pair form with its weight doubled does not."""
    model = seeded_weights(NCSNv2(Config(TINY)), 0).eval()
    score = make_score_fn(model, sigma_ladder(10.0, 0.1, 3, "geometric"))
    op, _ = operators("sense")
    pop, _ = pair_operators()
    y = op(torch.from_numpy(image()))
    y_pair = (y.real.contiguous(), y.imag.contiguous())
    cfg = map_opt.MAPConfig(n_iters=LONG_ITERS, lr=LR)
    if kind == "map":
        ours = map_opt.map_optimizer(score, y, op, 0.1, cfg, device="cpu")
        run = lambda w: map_pair.map_optimizer_pair(
            score, y_pair, pop, w, cfg, device="cpu")
    else:
        ours = map_opt.tv_reconstruction(y, op, 1e-3, cfg, device="cpu")
        run = lambda w: map_pair.tv_reconstruction_pair(
            y_pair, pop, w, cfg, device="cpu")
    weight = 0.1 if kind == "map" else 1e-3
    ref = run(weight)
    assert within(parting(ours, ref)), parting(ours, ref)
    assert not within(parting(run(2 * weight), ref))
