"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``): the same per-cell configs, a
record with the reference's keys (``run_s`` for ``lower_s`` and
``compile_s``, ``stand_ins`` added, no ``xla_cost_analysis``), the sweep
resumed from its cache, a failure recorded with its traceback, and one
full-width cell on ``meta``.

The reference's dry run needs 256 or 512 devices, so its record is not
run here; its keys and arithmetic are (``model_flops``,
``roofline_terms``)."""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.launch import hlo_analysis as jha  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, ShapeConfig,  # noqa: E402
                                 get_config, get_smoke)
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as ha  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402

# the reference's record (repro/launch/dryrun.py run_cell), less what has no
# counterpart here
REFERENCE_KEYS = {"arch", "shape", "mesh", "chips", "status",
                  "sharding_profile", "memory", "parsed", "roofline",
                  "model_flops", "useful_compute_ratio"}


@pytest.fixture(autouse=True)
def _one_thread_and_kernels():
    torch.set_num_threads(1)
    was = tops.kernels_enabled()
    tops.use_kernels(True)
    try:
        yield
    finally:
        tops.use_kernels(was)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cell_config_matches_reference(arch):
    from repro.launch.dryrun import cell_config as jcell_config
    assert list(ARCHS) == list(JARCHS) and list(SHAPES) == list(JSHAPES)
    for shape in SHAPES:
        got, want = dryrun.cell_config(arch, shape), jcell_config(arch, shape)
        assert got.sharding_profile == want.sharding_profile
        assert got.name == want.name


def _smoke_overrides(arch: str) -> dict:
    """The fields in which the smoke config differs from the full one."""
    full, smoke = get_config(arch), get_smoke(arch)
    return {f.name: getattr(smoke, f.name) for f in dataclasses.fields(full)
            if getattr(smoke, f.name) != getattr(full, f.name)}


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_run_cell_record_at_a_smoke_override(shape):
    """The record's keys and arithmetic: the reference's ``model_flops``,
    the roofline over the whole step (``chips=1``), the ratio of the
    model's FLOPs to the census's, the kernels' switch restored."""
    rec = dryrun.run_cell("granite-moe-3b-a800m", shape, False,
                          _smoke_overrides("granite-moe-3b-a800m"))
    assert REFERENCE_KEYS | {"run_s", "stand_ins"} == set(rec)
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["chips"] == 256 and tops.kernels_enabled()
    parsed = rec["parsed"]
    assert set(parsed) == {"flops", "bytes", "collective_bytes",
                           "collectives", "op_counts", "stand_ins",
                           "peak_bytes"}
    costs = ha.HloCosts(flops=parsed["flops"], bytes=parsed["bytes"],
                        collective_bytes=parsed["collective_bytes"])
    assert rec["roofline"] == jha.roofline_terms(
        costs, 1, peak_flops=989.4e12, hbm_bw=3.35e12, link_bw=450e9)
    cfg = dataclasses.replace(get_smoke("granite-moe-3b-a800m"))
    assert rec["model_flops"] == ha.model_flops(cfg, SHAPES[shape])
    assert rec["useful_compute_ratio"] == rec["model_flops"] / parsed["flops"]
    assert set(rec["memory"]) == {"argument_bytes", "peak_bytes"}
    assert 0 < rec["memory"]["argument_bytes"] < parsed["peak_bytes"]
    assert rec["stand_ins"] == parsed["stand_ins"] > 0


def test_argument_bytes_divide_by_the_axes_a_spec_names():
    """On a (1, 1) mesh the arguments' bytes are every argument's bytes;
    on (16, 16) each leaf over the axes its spec names."""
    cfg, shape = get_smoke("stablelm-1.6b"), ShapeConfig("d", 64, 32, "decode")
    whole = 0
    for sizes in ((1, 1), (16, 16)):
        mesh = make_mesh(sizes, ("data", "model"), device="meta")
        built = build_step(cfg, shape, mesh)
        args = dryrun.step_inputs(built, cfg, shape, "meta")
        got = dryrun.argument_bytes(built, args, shape, mesh)
        if sizes == (1, 1):
            whole = sum(t.numel() * t.element_size()
                        for t in ha._held(args))
            assert got == whole
        else:
            assert whole / 256 < got < whole
    assert dryrun._per_position(100, (None, ("data", "model")),
                                {"data": 16, "model": 16}) == 1
    assert dryrun._per_position(4096, ("model", None), {"model": 16}) == 256


def test_main_runs_resumes_and_records_a_failure(tmp_path, capsys,
                                                 monkeypatch):
    """One full-width cell on meta (stablelm-1.6b decode_32k, single
    mesh), its record written; run again it is cached; with a fault in the
    step builder it is recorded as an error with its traceback."""
    out = str(tmp_path)
    argv = ["--arch", "stablelm-1.6b", "--shape", "decode_32k", "--mesh",
            "single", "--out", out]
    dryrun.main(argv)
    path = tmp_path / "stablelm-1.6b__decode_32k__single.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and REFERENCE_KEYS <= set(rec)
    assert rec["parsed"]["flops"] > rec["model_flops"] > 0
    assert rec["roofline"]["dominant"] == "memory"
    assert rec["stand_ins"] > 0 and tops.kernels_enabled()
    assert "dry-run: 1 to run, 0 cached" in capsys.readouterr().out
    dryrun.main(argv + ["--list"])
    assert "dry-run: 0 to run, 1 cached" in capsys.readouterr().out

    def broken(*args, **kwargs):
        raise RuntimeError("induced fault")
    monkeypatch.setattr(dryrun, "build_step", broken)
    dryrun.main(argv + ["--force"])
    rec = json.loads(path.read_text())
    assert rec["status"] == "error" and "induced fault" in rec["error"]
    assert "Traceback" in rec["traceback"] and tops.kernels_enabled()
    dryrun.main(argv + ["--list"])
    assert "dry-run: 1 to run, 0 cached" in capsys.readouterr().out.split(
        "ERROR")[-1]


def test_long_500k_skips_full_attention_archs(tmp_path, capsys):
    dryrun.main(["--shape", "long_500k", "--list", "--out", str(tmp_path)])
    full = sum(not get_config(a).subquadratic for a in ARCHS)
    assert (f"{2 * (len(ARCHS) - full)} to run, 0 cached, {full} long_500k "
            f"skips") in capsys.readouterr().out
