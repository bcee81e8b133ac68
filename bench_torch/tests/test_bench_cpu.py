"""CPU rehearsal of the benchmark: every cell at a test-only tiny size
against the plain reference, the result line's keys, the faults and the
control that have to come out as not correct, the refusal to run without
a card, cells and metrics added as files, and the imports.

    python -m pytest bench_torch/tests -q
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench_torch import harness, profile, reference, workcount  # noqa: E402

TINY = dict(tris_target=3000, width=64, height=36, check_pixels=384,
            warmup_frames=1, trace_frames=2)
SEED = 2 ** 31 + 12345
WORKLOADS = [w["name"] for w in harness.load_json(
    os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(workload, trace=False, **kw):
    return harness.run(workload, SEED, 0.3, trace, t_start=time.perf_counter(),
                       device="cpu", overrides=TINY, **kw)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_against_reference(workload, capsys):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}
    harness.report(res)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    assert err.strip().splitlines()[-1].startswith("check image_off")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run_reads_its_layers(workload):
    res = _run(workload, trace=True)
    assert res["correct"]
    names = set(res["metrics"])
    assert "accel_setup_ms" in names
    assert ("rebuild_ms" in names) == ("rebuild" in workload)
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _half(cell):
    """Half of each frame left out: its lower rows never rendered."""
    render = cell.renderer.render_frame

    def frame():
        out = dict(render())
        h = out["valid"].shape[0] // 2
        for k, fill in (("valid", False), ("tri_id", -1), ("t", 0.0),
                        ("image", 0.0)):
            out[k] = out[k].clone()
            out[k][h:] = fill
        out["shadow"] = out["shadow"].clone()
        out["shadow"][:, h:] = 1.0
        return out
    cell.renderer.render_frame = frame


def _altered(cell):
    """An answer altered where it is produced: light 0's visibility
    flipped."""
    render = cell.renderer.render_frame

    def frame():
        out = dict(render())
        sh = out["shadow"].clone()
        sh[0] = 1.0 - sh[0]
        out["shadow"] = sh
        return out
    cell.renderer.render_frame = frame


def _unchanged(cell):
    """A step that returns its state unchanged: the frames after the first
    return the first one's outputs (the same accumulation, the same
    samples, the same pose's accel)."""
    render = cell.renderer.render_frame
    first = []

    def frame():
        if not first:
            first.append(render())
        return first[0]
    cell.renderer.render_frame = frame


# The static hard cells' frames do not change, so a frame returned
# unchanged is a correct frame there.
FAULTS = [(w, f) for w in WORKLOADS for f in (_half, _altered, _unchanged)
          if f is not _unchanged or "animated" in w or "soft" in w]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_fault_is_not_correct(workload, fault):
    res = _run(workload, fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    """The reference computed in bfloat16, put in the program's place,
    comes out as not correct through the run's own comparison, on the same
    frames and pixels on which the program's own numbers pass."""
    res = _run(workload, control=True)
    assert not res["correct"], res["checks"]
    control, program = res["_info"]["control"], res["_info"]["program"]
    assert {k: v["value"] for k, v in res["checks"].items()} == control
    limits = harness.find_cell(workload).limits
    assert all(program[k] <= limits[k] for k in harness.CHECKS), program


def _bench_cmd(cwd, env=None):
    return subprocess.run(
        [sys.executable, "bench_torch/run.py", "--workload", WORKLOADS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_refuses_without_a_card():
    env = dict(os.environ)
    if torch.cuda.is_available():
        env["CUDA_VISIBLE_DEVICES"] = ""
    proc = _bench_cmd(ROOT, env)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench_torch"),
                    tmp_path / "bench_torch")
    proc = _bench_cmd(tmp_path)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_cell_and_metric_added_as_files(tmp_path):
    """A new traffic mix, its limits, a per-layer metric and a walk-kernel
    pattern, each a new file, with entries in the manifest: the harness
    finds them all and edits nothing."""
    root = tmp_path
    shutil.copytree(os.path.join(ROOT, "bench_torch"), root / "bench_torch")
    for d in ("tpurt_torch", "native"):
        os.symlink(os.path.join(ROOT, d), root / d)
    bench = root / "bench_torch"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    traffic = json.loads((bench / "traffic" / "sun_1080p.json").read_text())
    traffic["lights"][0]["direction"] = [-0.3, 0.8, 0.1]
    (bench / "traffic" / "low_sun_1080p.json").write_text(json.dumps(traffic))
    (bench / "limits" / "hall_static.low_sun_1080p.json").write_text(
        (bench / "limits" / "hall_static.sun_1080p.json").read_text())
    (bench / "metrics" / "frames_traced").mkdir()
    (bench / "metrics" / "frames_traced" / "read.py").write_text(
        "def read(ctx):\n    return float(ctx.trace.frames)\n")
    (bench / "metrics" / "walk_roofline" / "kernels" / "new.txt").write_text(
        "# a walk kernel added later\n\\bnew_walk_kernel\\b\n")
    manifest = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    manifest["workloads"].append(
        {"name": "hall_static.low_sun_1080p", "config": "hall_static",
         "traffic": "low_sun_1080p", "chips": 1, "why": "a test cell"})
    manifest["per_layer"].append(
        {"name": "frames_traced", "unit": "frames", "better": "higher",
         "source": "device_trace", "layer": "device", "moves": "frame_ms",
         "workloads": ["hall_static.low_sun_1080p"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    res = harness.run("hall_static.low_sun_1080p", SEED, 0.3, True,
                      t_start=time.perf_counter(), device="cpu",
                      overrides=TINY, root=str(root))
    assert res["correct"]
    assert res["metrics"]["frames_traced"]["value"] == TINY["trace_frames"]
    from importlib import util
    spec = util.spec_from_file_location(
        "wr", bench / "metrics" / "walk_roofline" / "read.py")
    mod = util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    pats = mod.patterns(str(bench / "metrics" / "walk_roofline"))
    assert any(p.search("void new_walk_kernel<1>(Params)") for p in pats)
    assert any(p.search("void fused_shadows_kernel<0, 1>(Params)")
               for p in pats)
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_no_jax_or_tpurt_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|tpurt)(\.|\s|$)", re.M)
    for dirpath, _, files in os.walk(os.path.join(ROOT, "bench_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not pat.search(fh.read()), f
    code = ("import sys; sys.path.insert(0, %r); import bench_torch.harness,"
            " bench_torch.workcount, bench_torch.profile, tpurt_torch.app;"
            " print([m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'tpurt')])" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


def test_hall_is_the_programs_hall():
    from tpurt_torch import scenes
    from bench_torch import scene
    a, b = scenes.sponza_scene(260_000, seed=SEED), scene.hall(260_000, SEED)
    assert a.num_triangles == 287_176
    for k in ("vertices", "normals", "indices", "albedo"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    t = 1.25
    want = scenes.deform(a, t)
    got = scene.deform(torch.as_tensor(a.vertices), t, 0.35, 1.3).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_walk_count_matches_the_programs_plain_walk():
    """On a rebuilt accel (no camera ordering) the any-hit counts equal the
    program's plain version's; the nearest-first closest walk pops no
    more than the program's."""
    import tpurt_torch.kernels.traverse as tr
    cell = harness.Cell(harness.find_cell(
        "hall_rebuild.sun_1080p_animated"), SEED, "cpu", TINY)
    cell.step()
    work = workcount.frame_work(cell, cell.renderer.frame_index - 1)
    r = cell.renderer
    from tpurt_torch.camera import generate_rays
    o, d = generate_rays(r.camera, 64, 36, "cpu")
    args, kw, _, _ = tr.closest_shadow_inputs(
        r.accel, o, d, cell.lights[0].direction, 1e-3, r.attr_tables)
    stats = {}
    tr.closest_shadow_reference(*args, stats=stats, **kw)
    assert work["anyhit_tris"] == int(stats["anyhit_tris"])
    assert work["closest_tris"] <= int(stats["closest_tris"])
    assert work["ops"] > 0 and work["bound_ms"] > 0


def test_profile_summary():
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
           "dur": 10},
          {"ph": "X", "cat": "user_annotation", "name": "bench.frame",
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 5, "dur": 1, "args": {"correlation": 1}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 50, "dur": 1, "args": {"correlation": 2}},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 10, "dur": 20,
           "args": {"correlation": 1}},
          {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 25, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 60, "dur": 5,
           "args": {"correlation": 2}}]
    s = profile.summarize(ev, 1, 1e-4)
    assert s.busy_s == pytest.approx(30e-6)
    assert s.launches == 2
    assert s.breakdown["idle_gaps"] == [["bench.frame",
                                         pytest.approx(25e-6)]]
    assert s.breakdown["device_ops"][0] == ["a", pytest.approx(20e-6)]


def test_reference_samples_match_the_programs_stream():
    from tpurt_torch.app import frame_seed
    from tpurt_torch.kernels.sampling import sample_uniforms
    idx = torch.arange(0, 5000, 7)
    for seed in (0, SEED, 2 ** 40 + 3):
        fs = frame_seed(seed, 17)
        assert reference.frame_seed(seed, 17) == fs
        for li, s in ((0, 0), (2, 7)):
            a = sample_uniforms(fs, li, idx, s)
            b = reference.uniforms(fs, li, idx, s)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
