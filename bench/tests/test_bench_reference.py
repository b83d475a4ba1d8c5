"""The plain reference against the program at toy widths in float32 on the
CPU (the test imports both; the reference itself imports nothing of the
program), and the fp8 control's distance from it."""

import pytest
import torch

from bench.harness import weights as weights_mod
from bench.harness.loop import port_config
from bench.reference.decoder import forward_logits
from bench.tests.conftest import tiny_config


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("length", [5, 23])
def test_reference_matches_the_program_in_float32(gated, length):
    from repro_torch.models import api, lm
    cfg = tiny_config("float32", gated=gated)
    w = weights_mod.make(cfg, 2 ** 33 + length, "cpu")
    params = weights_mod.program_params(lm, port_config(cfg), w)
    toks = torch.randint(0, cfg["vocab_size"], (length,),
                         generator=torch.Generator().manual_seed(length))
    prog, _ = api.prefill_fn(params, {"tokens": toks[None].int()},
                             port_config(cfg), 64)
    ref = forward_logits(cfg, w.__getitem__, [toks], [0])[0]
    assert ref.shape == (length, cfg["vocab_size"])
    torch.testing.assert_close(prog[0, 0, :cfg["vocab_size"]], ref[-1],
                               rtol=1e-4, atol=1e-4)


def test_the_fp8_control_departs_from_the_reference():
    cfg = tiny_config("float32")
    w = weights_mod.make(cfg, 5, "cpu")
    toks = torch.arange(17) % cfg["vocab_size"]
    ref = forward_logits(cfg, w.__getitem__, [toks], [0])[0]
    low = forward_logits(cfg, w.__getitem__, [toks], [0], quant="fp8")[0]
    assert (low - ref).abs().max() > 1e-2


def test_weights_come_from_the_seed_and_fill_the_program():
    from repro_torch.models import lm
    cfg = tiny_config()
    a = weights_mod.make(cfg, 2 ** 35 + 1, "cpu")
    b = weights_mod.make(cfg, 2 ** 35 + 1, "cpu")
    c = weights_mod.make(cfg, 2 ** 35 + 2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.0.attn.wq"], c["layers.0.attn.wq"])
    assert a["layers.1.norm2.scale"].eq(1).all()
    params = weights_mod.program_params(lm, port_config(cfg), a)
    assert params.unit[0][1].attn["wq"].data_ptr() == \
        a["layers.1.attn.wq"].data_ptr()
    del a["final_norm.bias"]
    with pytest.raises(ValueError):
        weights_mod.program_params(lm, port_config(cfg), a)
