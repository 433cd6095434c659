"""The port's measurement tools against the JAX package's ``tools/``.

Every case runs both packages on the same weights: one reference-layout
checkpoint (``make_reference_state_dict``'s weights tempered by
fan_in^-0.5, ``tests/test_torch_checkpoint.py::tempered_state_dict``),
converted by each package's loader, with ``named_config`` swapped in both for
the named configuration cut to a 2-block, 32-wide ViT (``vit_override``) at
56 x 56, 4 person slots and a 1-layer head, and both factories' body model
cut to the 64-vertex ``synthetic_body_model`` with SMPL-X's joint layout.
The JAX side runs as its own tests run it on the CPU (flash through its
plain reference).

  * ``parity_harness``: ``STAGE_KEYS`` and ``_delta_stats`` equal;
    ``capture_stages``' five stages within 1e-4 of the largest magnitude of
    the JAX ones at fp32; ``main`` on dumps written from the JAX forward
    exits 0, and 1 on a dump moved by 1 mm; ``run_check_assets`` on
    ``tests/test_manifest.py``'s fixture prints what the JAX one prints.
  * ``bench_eval``: ``build_fixture_dataset`` bitwise equal in both wires,
    ``calibrate_det_thresh`` within 1e-5; ``main`` prints the JAX keys.
  * ``train/evaluate.py::evaluate_dataset`` on the uint8 fixture set gives
    the JAX function's metrics within 1e-4, pipelined and serial (uint8
    images are normalized on the device, as the JAX function does).
  * ``bf16_sensitivity.run_config``: the JAX keys and sample count; the
    fp32 side's v3d within 1e-4 of the JAX fp32 side's.
  * ``sweep_capacity`` and ``profile_model`` run on the CPU and print the
    JAX lines' fields.
"""

import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multihmr_tpu import config as jconfig
from multihmr_tpu_torch import config as tconfig
from tests.test_manifest import write_smplx_fixture
from tests.test_torch_checkpoint import _small_bodies, _tempered_file
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

REPO = Path(__file__).resolve().parents[1]
NAME = "multiHMR_672_S"
S = 56


def _jax_tool(name):
    """A module of the JAX package's ``tools/`` directory."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


NAMED = {jconfig: jconfig.named_config, tconfig: tconfig.named_config}  # the packages' own


def _tiny_named(cfg_mod, compute_dtype):
    base = NAMED[cfg_mod]

    def named(name):
        return dataclasses.replace(
            base(name), img_size=S, max_people=4, xat_depth=1, compute_dtype=compute_dtype,
            vit_override=cfg_mod.ViTConfig(embed_dim=32, depth=2, num_heads=2))

    return named


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """Swap both packages' named configurations for the tiny ones (fp32
    compute unless a test swaps again) and their body models for the small
    one; write the checkpoint. Returns its path."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("SMPLX_DIR", raising=False)
    _small_bodies(monkeypatch)
    set_dtype(monkeypatch, "float32")
    path = str(tmp_path / "tiny.pt")
    _tempered_file(path, _tiny_named(jconfig, "float32")(NAME))
    return path


def set_dtype(monkeypatch, compute_dtype):
    import multihmr_tpu.factory as jfactory
    import multihmr_tpu_torch.factory as tfactory
    from multihmr_tpu_torch.tools import bf16_sensitivity, sweep_capacity

    jnamed, tnamed = _tiny_named(jconfig, compute_dtype), _tiny_named(tconfig, compute_dtype)
    for mod in (jconfig, jfactory):
        monkeypatch.setattr(mod, "named_config", jnamed)
    for mod in (tconfig, tfactory, bf16_sensitivity, sweep_capacity):
        monkeypatch.setattr(mod, "named_config", tnamed)


def _models(ckpt):
    from multihmr_tpu.factory import build_model as jbuild
    from multihmr_tpu_torch.factory import build_model as tbuild

    jm, params = jbuild(NAME, checkpoint=ckpt)
    return jm, params, tbuild(NAME, device="cpu", checkpoint=ckpt)


def _K():
    from multihmr_tpu_torch.io.preprocessing import get_camera_parameters

    return get_camera_parameters(S, fov=60)


def _gap_thresh(score_lists):
    """A threshold in the middle of the widest gap between the sorted scores
    of every image, below the largest score of each (so each image keeps a
    person): no rounding can move a score across it."""
    s = np.sort(np.concatenate(score_lists))[::-1]
    top = min(float(np.max(x)) for x in score_lists)
    gaps = [(s[i] - s[i + 1], (s[i] + s[i + 1]) / 2) for i in range(len(s) - 1) if s[i] <= top]
    return float(max(gaps)[1])


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (err, scale)
    return err


# ---- parity_harness ----

def test_parity_stage_keys_and_delta_stats_equal():
    from multihmr_tpu_torch.tools import parity_harness as tph

    jph = _jax_tool("parity_harness")
    assert tph.STAGE_KEYS == jph.STAGE_KEYS
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(7, 5)), rng.normal(size=(7, 5)).astype(np.float32)
    for x, y in ((a, b), (a, a), (a, a.T), (a[:0], a[:0]), (a.reshape(-1), b.reshape(-1))):
        assert tph._delta_stats(x, y) == jph._delta_stats(x, y)


def test_capture_stages_matches_jax(tiny):
    from multihmr_tpu_torch.tools import parity_harness as tph

    jph = _jax_tool("parity_harness")
    jm, params, tm = _models(tiny)
    x = np.random.default_rng(2).normal(size=(1, S, S, 3)).astype(np.float32)
    K = _K()
    probe = jm.forward(params, jnp.asarray(x), jnp.asarray(K), det_thresh=0.0)
    thr = _gap_thresh([np.asarray(probe["scores_det"][0])])
    jout, jst = jph.capture_stages(jm, params, jnp.asarray(x), jnp.asarray(K), thr, 3)
    tout, tst = tph.capture_stages(tm, torch.from_numpy(x), torch.from_numpy(K), thr, 3)
    assert sorted(tst) == sorted(jst) == sorted(tph.STAGE_KEYS)
    n = int(np.asarray(jout["det"].valid).sum())
    assert n >= 1 and tst["hph_cam"].shape == (n,)
    for k in tph.STAGE_KEYS:
        _close(tst[k], jst[k])
    jp, tp = jm.extract_persons(jout)[0], tm.extract_persons(tout)[0]
    assert len(tp) == len(jp) == n
    for a, b in zip(jp, tp):
        _close(b["v3d"], a["v3d"])


def _write_dumps(tmp, jm, params, perturb):
    """Two PNGs and their reference-side dumps from the JAX forward (stages
    included); returns (img_dir, dump_dir, det_thresh)."""
    from PIL import Image

    from multihmr_tpu.io.preprocessing import open_image as jopen

    jph = _jax_tool("parity_harness")
    img_dir, dump_dir = tmp / "imgs", tmp / "dumps"
    img_dir.mkdir()
    dump_dir.mkdir()
    rng = np.random.default_rng(4)
    xs = {}
    for i in range(2):
        name = f"im{i}.png"
        Image.fromarray(rng.integers(0, 256, size=(40 + 8 * i, 48, 3), dtype=np.uint8)).save(
            img_dir / name)
        xs[name] = jnp.asarray(jopen(str(img_dir / name), S)[0])
    K = jnp.asarray(_K())
    thr = _gap_thresh([np.asarray(jm.forward(params, x, K, det_thresh=0.0)["scores_det"][0])
                       for x in xs.values()])
    for name, x in xs.items():
        out, stages = jph.capture_stages(jm, params, x, K, thr, 3)
        persons = jm.extract_persons(out)[0]
        dump = {f"stage_{k}": v for k, v in stages.items()}
        for i, p in enumerate(persons):
            dump[f"v3d_{i}"] = np.asarray(p["v3d"]).copy()
            if perturb and i == 0:  # 1 mm along x
                dump[f"v3d_{i}"][:, 0] += 1e-3
            dump[f"transl_pelvis_{i}"] = np.asarray(p["transl_pelvis"])
            dump[f"scores_{i}"] = np.asarray(p["scores"])
        np.savez(dump_dir / name.replace(".png", ".npz"), **dump)
    return img_dir, dump_dir, thr


@pytest.mark.parametrize("perturb", [False, True])
def test_parity_main_on_jax_dumps(tiny, tmp_path, capsys, perturb):
    from multihmr_tpu_torch.tools import parity_harness as tph

    jm, params, _ = _models(tiny)
    img_dir, dump_dir, thr = _write_dumps(tmp_path, jm, params, perturb)
    rc = tph.main(["--ckpt", tiny, "--img_folder", str(img_dir), "--reference_dumps",
                   str(dump_dir), "--model_name", NAME, "--det_thresh", str(thr),
                   "--device", "cpu", "--json_out", str(tmp_path / "report.json")])
    out = capsys.readouterr().out
    assert rc == (1 if perturb else 0), out
    report = json.load(open(tmp_path / "report.json"))
    assert report["count_mismatches"] == 0 and len(report["images"]) == 2
    for entry in report["images"].values():
        assert sorted(entry["stages"]) == sorted(tph.STAGE_KEYS)
        assert all(st["max_abs"] <= 1e-4 * max(1.0, 10 * st["ref_scale"])
                   for st in entry["stages"].values())
    if perturb:  # 1 mm on every vertex of one person
        assert 0.99 < report["max_pve_mm"] < 1.01
    else:  # fp32 on both sides: measured 5.4e-3 mm with the persons 5 m away
        assert report["max_pve_mm"] < 0.05
    assert "max PVE delta" in out and "stage backbone" in out
    # no dump for the folder: exit 2, as the JAX harness
    empty = tmp_path / "none"
    empty.mkdir()
    assert tph.main(["--ckpt", tiny, "--img_folder", str(img_dir), "--reference_dumps",
                     str(empty), "--model_name", NAME, "--device", "cpu"]) == 2


def test_run_check_assets_matches_jax(tmp_path, capsys):
    from multihmr_tpu_torch.tools import parity_harness as tph

    jph = _jax_tool("parity_harness")
    (tmp_path / "smplx").mkdir()
    write_smplx_fixture(tmp_path / "smplx" / "SMPLX_NEUTRAL.npz")
    empty = tmp_path / "empty"
    empty.mkdir()
    for d, rc in ((tmp_path, 0), (empty, 1)):
        assert jph.run_check_assets(str(d)) == rc
        want = capsys.readouterr().out
        assert tph.run_check_assets(str(d)) == rc
        assert capsys.readouterr().out == want
    assert "manifest: OK" in want or rc == 1


# ---- bench_eval and evaluate_dataset's uint8 path ----

@pytest.mark.parametrize("wire", ["f32", "u8"])
def test_fixture_dataset_bitwise_and_calibration(tiny, wire):
    from multihmr_tpu_torch.tools import bench_eval as tbe

    jbe = _jax_tool("bench_eval")
    jm, params, tm = _models(tiny)
    np.testing.assert_array_equal(tm.body_model.v_template.numpy(),
                                  np.asarray(jm.body_model.v_template))
    want = jbe.build_fixture_dataset(jm, 6, seed=3, wire=wire)
    got = tbe.build_fixture_dataset(tm, 6, seed=3, wire=wire)
    assert len(got) == len(want) == 6
    for (xg, ag), (xw, aw) in zip(got, want):
        assert xg.dtype == xw.dtype == (np.uint8 if wire == "u8" else np.float32)
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(ag["K"], aw["K"])
        assert len(ag["humans"]) == len(aw["humans"])
        for hg, hw in zip(ag["humans"], aw["humans"]):
            np.testing.assert_array_equal(hg["smplx_vertices"], hw["smplx_vertices"])
        for k in ("v3d", "j3d", "j2d"):
            np.testing.assert_array_equal(ag["gt"][k], aw["gt"][k])
    t_thr = tbe.calibrate_det_thresh(tm, got[0])
    j_thr = jbe.calibrate_det_thresh(jm, params, want[0])
    assert abs(t_thr - j_thr) <= 1e-5


@pytest.mark.parametrize("pipeline", [True, False])
def test_evaluate_uint8_matches_jax(tiny, pipeline):
    """The uint8 images are normalized on the device as the JAX function
    does; ``pipeline`` picks the loop on both sides."""
    from multihmr_tpu.train.evaluate import evaluate_dataset as jeval
    from multihmr_tpu_torch.io.preprocessing import normalize_nhwc
    from multihmr_tpu_torch.tools import bench_eval as tbe
    from multihmr_tpu_torch.train.evaluate import evaluate_dataset as teval

    jm, params, tm = _models(tiny)
    ds = tbe.build_fixture_dataset(tm, 6, seed=5, wire="u8")
    thr = tbe.calibrate_det_thresh(tm, ds[0])
    gt = lambda annot: annot["gt"]  # noqa: E731
    want = jeval(jm, params, ds, det_thresh=thr, gt_forward=gt, log_every=0, pipeline=pipeline)
    got = teval(tm, ds, det_thresh=thr, gt_forward=gt, log_every=0, pipeline=pipeline)
    assert sorted(got) == sorted(want) and sorted(got["timings"]) == sorted(want["timings"])
    assert got["n_images"] == 6 and want["recall"] > 0
    for k in ("pve", "pa_pve", "precision", "recall", "f1_score"):
        assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), (k, got[k], want[k])
    other = teval(tm, ds, det_thresh=thr, gt_forward=gt, log_every=0, pipeline=not pipeline)
    assert {k: v for k, v in other.items() if k != "timings"} == \
        {k: v for k, v in got.items() if k != "timings"}
    # the same pixels normalized on the host give the same metrics
    f32 = [(normalize_nhwc(x), a) for x, a in ds]
    host = teval(tm, f32, det_thresh=thr, gt_forward=gt, log_every=0, pipeline=pipeline)
    for k in ("pve", "pa_pve", "f1_score"):
        assert abs(host[k] - got[k]) <= 1e-6 * max(1.0, abs(got[k])), k


JAX_EVAL_KEYS = {"model", "images", "wire", "persons_detected", "wall_s", "images_per_s",
                 "phases_s", "attributed_frac", "serial_wall_s", "pipeline_speedup", "f1"}


def test_bench_eval_main_prints_the_jax_keys(tiny, capsys):
    from multihmr_tpu_torch.tools import bench_eval as tbe

    assert tbe.main(["--model_name", NAME, "--images", "5", "--wire", "u8", "--device", "cpu",
                     "--json_out", "eval.json"]) == 0
    entry = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(entry) == JAX_EVAL_KEYS
    assert entry["images"] == 5 and entry["wire"] == "u8" and entry["persons_detected"] >= 5
    assert set(entry["phases_s"]) == {"load", "dispatch", "wait", "readback", "gt",
                                      "match_metrics", "visu"}
    assert json.load(open("eval.json")) == {f"eval_sweep_{NAME}": entry}


# ---- bf16_sensitivity ----

def test_bf16_sensitivity_matches_jax(tiny, monkeypatch):
    from multihmr_tpu.factory import build_model as jbuild
    from multihmr_tpu.ops.detection import Detections as JDetections
    from multihmr_tpu_torch.factory import build_model as tbuild
    from multihmr_tpu_torch.tools import bf16_sensitivity as tbs
    from multihmr_tpu_torch.utils.precision import cast_backbone_bf16

    set_dtype(monkeypatch, "bfloat16")  # the production configuration
    jbs = _jax_tool("bf16_sensitivity")
    assert tbs.DEFAULT_CONFIGS == jbs.DEFAULT_CONFIGS
    want = jbs.run_config(NAME, 1, 2, 2, ckpt=tiny)
    got = tbs.run_config(NAME, 1, 2, 2, ckpt=tiny, device="cpu")
    assert sorted(got) == sorted(want) and got["samples"] == want["samples"] == 4
    for k in ("v3d_raw_mm", "v3d_pelvis_centered_mm"):
        assert sorted(got[k]) == sorted(want[k]) == ["max", "p50", "p99"]
        assert all(np.isfinite(v) and v >= 0 for v in got[k].values())

    # the fp32 sides on one image, under the same injected slots
    cfg32 = dataclasses.replace(tconfig.named_config(NAME), compute_dtype="float32")
    m32 = tbuild(NAME, device="cpu", cfg=cfg32, checkpoint=tiny)
    m16 = tbs.twin(m32, tconfig.named_config(NAME))
    cast_backbone_bf16(m16.net)
    x = tbs.image(S, 0, 0)
    raw, cen, v32 = tbs.compare(m16, m32, x, 2)
    assert len(raw) == len(cen) == 2 and v32.shape == (2, 64, 3)
    jm32, p32 = jbuild(NAME, cfg=dataclasses.replace(jconfig.named_config(NAME),
                                                     compute_dtype="float32"), checkpoint=tiny)
    rows, cols, valid = tbs.injected_slots(S // 14, 4, 2)
    det = JDetections(rows=jnp.asarray(rows, jnp.int32), cols=jnp.asarray(cols, jnp.int32),
                      scores=jnp.asarray(valid), valid=jnp.asarray(valid))
    out = jm32.forward(p32, jnp.asarray(x), jnp.asarray(_K()), is_training=True,
                       gt_det=det, batch_mode="fused")
    _close(v32, np.asarray(out["v3d"][0, :2]))


# ---- sweep_capacity and profile_model ----

def test_sweep_capacity_runs(tiny, capsys):
    from multihmr_tpu_torch.tools import sweep_capacity

    r = sweep_capacity.run_point(NAME, 8, device="cpu", iters=1, repeats=2)
    # the JAX point's keys, compile_s renamed: no compile happens here
    assert sorted(r) == ["capacity", "first_call_s", "ms_per_img"] and r["capacity"] == 8
    assert r["ms_per_img"] > 0 and r["first_call_s"] >= 0
    assert sweep_capacity.main(["--configs", NAME, "--capacities", "2,4", "--iters", "1",
                                "--device", "cpu", "--json_out", "k.json"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [(x["config"], x["capacity"]) for x in lines] == [(NAME, 2), (NAME, 4)]
    assert json.load(open("k.json"))["k_capacity"][NAME] == [
        {k: v for k, v in x.items() if k != "config"} for x in lines]


def test_profile_model_main_cpu(tiny, capsys):
    from multihmr_tpu_torch.tools import profile_model

    assert profile_model.main(["--model_name", NAME, "--device", "cpu", "--stages",
                               "--ops", "5", "--iters", "1", "--trace", "trace"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{NAME} B=1 (heads): ") and out[0].endswith("[cpu]")
    for field in ("ms/batch", "ms/img", "img/s"):
        assert field in out[0]
    assert out[1].startswith("  vit: ") and "(rest: " in out[1]
    assert "trace written to" in out[2] and os.listdir("trace")
    assert out[3].split() == ["ms/run", "count", "op"] and len(out) == 4 + 5
    ms = [float(line.split()[0]) for line in out[4:]]
    assert ms == sorted(ms, reverse=True)
