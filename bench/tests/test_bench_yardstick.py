"""The frozen yardsticks on hand-worked shapes."""

import json

import pytest

from bench.tests.conftest import BENCH
from bench.yardstick import kernel_cost, model_cost
from bench.yardstick.intervals import gaps, union_length


def test_gather_bytes_at_the_stablelm_pool():
    # kernel 1 on lines [49152, 32, 32] int32, 49152 live frames, out
    # [1536, 32, 32, 32] int32: 4096-byte frames read, the index, the output
    frame = 32 * 32 * 4
    out = 1536 * 32 * 32 * 32 * 4
    got = kernel_cost.launch_bytes(kernel_cost.GATHER, 49152, frame,
                                   49152 * 4, out)
    assert got == 402_849_792


def test_scatter_bytes_count_live_frames_twice_and_no_sentinel():
    frame = 32 * 32 * 4
    assert kernel_cost.launch_bytes(kernel_cost.SCATTER, 49152, frame,
                                    49152 * 4) == 402_849_792
    # 18,432 sentinel entries of a 49,152-entry index move nothing
    assert kernel_cost.scatter_bytes(30720, frame, 49152 * 4) == \
        2 * 30720 * frame + 196_608


def test_unknown_kernel_has_no_frozen_cost():
    with pytest.raises(KeyError):
        kernel_cost.launch_bytes("medusa_transpose_tiles", 1, 1, 1)


@pytest.mark.parametrize("spans, covered", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 15)], 15.0),              # overlap counted once
    ([(20, 30), (0, 10), (2, 4)], 20.0),     # unsorted, nested
])
def test_union_length(spans, covered):
    assert union_length(spans) == covered


def test_gaps_are_the_uncovered_stretches():
    assert gaps([(2, 4), (3, 6), (8, 9)], 0, 10) == [(0, 2), (6, 8), (9, 10)]
    assert gaps([(0, 10)], 0, 10) == []
    assert gaps([], 1, 3) == [(1, 3)]


def _config(name):
    with open(BENCH / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_widths_of_the_two_configurations():
    st = model_cost.widths(_config("stablelm-1.6b"))
    sc = model_cost.widths(_config("starcoder2-15b"))
    assert st.kv_bytes_per_token == 196_608
    assert sc.kv_bytes_per_token == 81_920
    # the port's param_count() less the norms' 2 * d a layer
    assert st.weight_bytes == 2 * (1_438_744_576 - 24 * 2 * 2048)
    assert sc.weight_bytes == 2 * (15_653_634_048 - 40 * 2 * 6144)


def test_operations_and_bytes_on_a_hand_worked_model():
    w = model_cost.Widths(layers=2, d_model=4, heads=2, kv_heads=1,
                          head_dim=2, d_ff=8, vocab=10, gated=False,
                          tied=True)
    # a layer: q 4x4, k 4x2, v 4x2, o 4x4, up 4x8, out 8x4
    assert w.layer_weights == 16 + 8 + 8 + 16 + 32 + 32
    # 3 prompt tokens: 2 flop a weight a token, keys 1 + 2 + 3 = 6, one head
    assert model_cost.prefill_flops(w, 3) == (
        2 * 2 * 112 * 3 + 4 * 2 * 2 * 2 * 6 + 2 * 40)
    assert model_cost.decode_flops(w, 5) == 2 * 2 * 112 + 4 * 2 * 2 * 2 * 5 \
        + 2 * 40
    kv = 2 * 2 * 1 * 2 * 2                     # K and V, 2 layers, bf16
    assert model_cost.prefill_bytes(w, 3) == w.weight_bytes + 3 * kv
    assert model_cost.decode_step_bytes(w, [4, 6]) == \
        w.weight_bytes + (4 + 6 + 2) * kv
    assert model_cost.decode_step_bytes(w, []) == 0


def test_trace_reduction_on_a_hand_made_slice():
    from bench.harness.trace import reduce
    # two steps: step 0 admits; each starts with its marker (1 us)
    ev = [("spin_kernel", 0.0, 1.0), ("gemm", 3.0, 10.0),
          ("gather_burst_kernel<uint4>", 10.0, 12.0),
          ("spin_kernel", 20.0, 21.0), ("copy", 21.0, 30.0),
          ("gather_burst_kernel<uint4>", 35.0, 36.0)]
    t = reduce(ev, [True, False])
    assert t.steps == 2
    assert t.window_s == pytest.approx(36e-6)
    assert t.busy_s == pytest.approx(19e-6)
    assert t.kernel_time("gather_burst_kernel") == (2, pytest.approx(3e-6))
    assert "spin_kernel" not in t.ops
    assert t.idle == [("client", pytest.approx(8e-6)),
                      ("decode_step", pytest.approx(5e-6)),
                      ("admit_step", pytest.approx(2e-6))]
