"""The port's profiling instrument (``repro_torch.launch.profile``): the
per-op breakdown's totals equal the census's (``analyze_step``), as the
reference's breakdown's equal its ``analyze_hlo``; the CLI on ``meta``;
the card's census refuses to run without a card."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.launch.profile import breakdown as jbreakdown  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import profile  # noqa: E402
from repro_torch.launch.hlo_analysis import analyze_step  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread_and_kernels():
    torch.set_num_threads(1)
    was = tops.kernels_enabled()
    try:
        yield
    finally:
        tops.use_kernels(was)


def test_breakdown_totals_match_analyzer():
    """Six trips of ``tanh(c @ w)`` then a sum: the breakdown's totals are
    the census's, its lines sorted by bytes, and its FLOPs the reference
    breakdown's of the same scan."""
    w = torch.ones(64, 64)

    def f(x):
        for _ in range(6):
            x = torch.tanh(x @ w)
        return x.sum()

    _, costs = analyze_step(f, torch.ones(64, 64))
    ops, totals = profile.breakdown(costs)
    assert totals == {"bytes": costs.bytes, "flops": costs.flops,
                      "collective_bytes": costs.collective_bytes}
    assert [c.bytes for c in ops] == sorted((c.bytes for c in ops),
                                            reverse=True)
    jw = jnp.ones((64, 64))

    def jf(x):
        y, _ = jax.lax.scan(lambda c, _: (jnp.tanh(c @ jw), None), x, None,
                            length=6)
        return y.sum()

    txt = jax.jit(jf).lower(jnp.ones((64, 64))).compile().as_text()
    assert totals["flops"] == jbreakdown(txt)[1]["flops"] == \
        analyze_hlo(txt).flops == 6 * 2 * 64 ** 3
    mm = next(c for c in ops if c.op == "aten.mm.default")
    assert mm.line == "mm(f32[64,64], f32[64,64])" and mm.bytes == 6 * 3 * 16384


def test_print_breakdown_at_the_h100_rates(capsys):
    _, costs = analyze_step(lambda x: (x @ x).sum(), torch.ones(32, 32))
    ops, totals = profile.breakdown(costs)
    profile.print_breakdown(ops, totals, top=1)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"memory {totals['bytes']:.3e} B = "
                             f"{totals['bytes'] / 3.35e12:.4f}s")
    assert len(out) == 2 and "mm" in out[1]


def test_device_census_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the refusal")
    with pytest.raises(RuntimeError, match="CUDA card"):
        profile.device_census(lambda: None)
    with pytest.raises(RuntimeError, match="CUDA card"):
        profile.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k",
                      "--device", "cuda"])


def test_cli_on_meta(capsys):
    """The CLI at stablelm-1.6b's decode_32k, depth cut by ``--set`` and
    scale by ``--batch``/``--seq``: shapes alone, the kernels' switch
    restored, the table printed."""
    tops.use_kernels(True)
    costs = profile.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k",
                          "--set", "n_layers=2", "--batch", "8", "--seq",
                          "1024", "--top", "5"])
    assert tops.kernels_enabled() and costs.flops > 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("stablelm-1.6b decode_32k (8 x 1024) on meta")
    assert out[1].startswith("memory ") and len(out) == 7
