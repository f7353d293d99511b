"""The port's dry run (``repro_torch.launch.dryrun``) and what it stands on:
the ``rgb`` custom op's CPU and meta implementations, the record transport
(``dist``, ``RecordingMesh``), ``roofline.count_meta`` / ``LiveBytes``.

Against the reference's HLO: a subprocess (the reference's dry run forces
512 host devices when imported) compiles the reference's steps on the
smoke configs in float32 at ``make_host_mesh(2, 2)``, batch 4, sequence
32, and splits its collectives by op, by whether they sit inside
``shard_map`` and by the axes they reduce over; the counts are its depth-1
and depth-2 probes extrapolated (``_probe_roofline``'s arithmetic).  The
port runs the same steps, with the probe's overrides, on rank 0 of a
2x2 ``RecordingMesh``.  Where an op differs the test states by how much
and why (ROADMAP C records each):

* serving: the port gathers the logits over the data axes
  (``steps._gather_rows``; the reference returns them batch-sharded):
  ``B x V_pad x 4`` more all-gather bytes;
* training: every reference all-gather lies outside ``shard_map``, its
  partitioner's re-gathers of model-sharded leaves in the optimizer; the
  port's are the duplicated-KV sync's whole-leaf gathers, exactly;
  data-axis all-reduces agree within two f32 scalars; model-axis
  all-reduces within 1 KiB (the reference psums the replicated norm
  weights' gradients over the model axis, which the port's Megatron
  placement has whole, and groups the clip norm's scalars otherwise),
  after mamba2's B and C cotangents, which the port sums over the model
  axis where the reference folds them into its d_model-wide sum;
* bfloat16: the reference's CPU HLO carries bf16 activations as f32 and
  halves only collectives of 1 MiB or more, so at the smoke size its
  all-reduce bytes are twice the port's.

Argument bytes equal ``memory_analysis().argument_size_in_bytes`` but
where jit drops an unused argument (an SSM's decode positions).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_compat  # noqa: F401  (this worker's torch threads)
from repro_torch import dist as D
from repro_torch.configs import ARCHS, SHAPES, InputShape, smoke_config
from repro_torch.kernels.batch_lp import (finish_cuda, prep_cuda, rgb_cuda,
                                          rgb_flops, rgb_plain)
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import (HostMesh, RecordingMesh,
                                     make_production_mesh)
from repro_torch.optim import AdamW
from repro_torch.roofline import LiveBytes, count_call, count_meta

REPO = Path(__file__).resolve().parents[1]
H100 = "NVIDIA H100 80GB HBM3"
B, S = 4, 32

# (arch, kind, dtype): the cells held against the reference's HLO
HLO_CASES = [("qwen2-0.5b", "train", "float32"),
             ("qwen2-0.5b", "prefill", "float32"),
             ("qwen2-0.5b", "decode", "float32"),
             ("olmoe-1b-7b", "train", "float32"),
             ("mamba2-1.3b", "train", "float32"),
             ("mamba2-1.3b", "decode", "float32"),
             ("qwen2-0.5b", "decode", "bfloat16")]

_REFERENCE = r'''
import dataclasses, json, re, sys
from repro.launch import dryrun as R   # forces 512 host devices
from repro.configs import ARCHS, InputShape, smoke_config
from repro.launch.mesh import make_host_mesh
from repro.roofline import _OP_RE, _type_bytes

# the 2x2 (data, model) host mesh's replica groups
GROUPS = {"{{0,1},{2,3}}": "model", "[2,2]<=[4]": "model",
          "{{0,2},{1,3}}": "data", "[2,2]<=[2,2]T(1,0)": "data",
          "{{0,1,2,3}}": "data,model", "[1,4]<=[4]": "data,model"}

def split(text):
    out = {}
    for line in text.splitlines():
        m = _OP_RE.match(line)
        if not m or f"{m.group(2)}-done(" in line:
            continue
        g = re.search(r"replica_groups=(.*?), (?:use_global|to_apply|"
                      r"dimensions|channel)", line).group(1)
        where = "in" if "shard_map" in line else "out"
        k = f"{m.group(2)}|{where}|{GROUPS[g]}"
        out[k] = out.get(k, 0) + _type_bytes(m.group(1))
    return out

mesh = make_host_mesh(2, 2)
res = {}
for arch, kind, dtype in json.loads(sys.argv[1]):
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype=dtype)
    shape = InputShape(kind, kind, 32, 4)
    c1, c2, units = R._probe_cfgs(cfg)
    s1 = split(R._compile_step(c1, shape, mesh).as_text())
    s2 = split(R._compile_step(c2, shape, mesh).as_text())
    coll = {k: s1.get(k, 0) + (units - 1) * (s2.get(k, 0) - s1.get(k, 0))
            for k in set(s1) | set(s2)}
    full = R._compile_step(cfg, shape, mesh)
    res[f"{arch}/{kind}/{dtype}"] = {
        "coll": coll,
        "arg": full.memory_analysis().argument_size_in_bytes}
print(json.dumps(res))
'''


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """Two subprocesses run alongside this module's other tests: the
    reference's compiles (:func:`_reference` waits for them) and the
    command line's qwen2-0.5b ``prefill_32k`` cell, whose chunked attention
    is the slowest meta run here (:func:`_prefill_record`)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    out = tmp_path_factory.mktemp("dryrun") / "prefill.json"
    procs = {
        "ref": subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, json.dumps(HLO_CASES)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
        "prefill": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "qwen2-0.5b", "--shape", "prefill_32k", "--peaks", H100,
             "--out", str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)}
    _BG.update(procs=procs, prefill_out=out)
    yield
    for proc in procs.values():
        proc.kill()
        proc.communicate()


_BG: dict = {}


def _wait(name: str) -> str:
    proc = _BG["procs"][name]
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return out


def _reference() -> dict:
    if "ref" not in _BG:
        _BG["ref"] = json.loads(_wait("ref").strip().splitlines()[-1])
    return _BG["ref"]


def _prefill_record() -> dict:
    if "prefill" not in _BG:
        _wait("prefill")
        (_BG["prefill"],) = json.loads(_BG["prefill_out"].read_text())
    return _BG["prefill"]


def _smoke(arch, dtype="float32", **kw):
    return dataclasses.replace(smoke_config(ARCHS[arch]), dtype=dtype, **kw)


def _port(arch, kind, dtype) -> dict:
    """The port's probe-config collectives by op and axes, and the real
    config's argument bytes, on rank 0 of a 2x2 RecordingMesh."""
    mesh = RecordingMesh(("data", "model"), (2, 2))
    shape = InputShape(kind, kind, S, B)
    prog, args, _ = dryrun.build_step(_smoke(arch, dtype, **dryrun.PROBE),
                                      shape, mesh, memory_bytes=80e9)
    D.reset_counts()
    count_meta(prog.step, args, live=False, ops=False)
    rec = D.recorded()
    res = dryrun.dryrun_step(_smoke(arch, dtype), shape, mesh, peaks=H100)
    return {"rec": rec, "arg": res["memory"]["argument_bytes"],
            "model": prog.model}


def _axes(rec, op, axes):
    return rec.get(op, {"by_axes": {}})["by_axes"].get(axes, 0)


def _ref_axes(coll, op, where, axes):
    return coll.get(f"{op}|{where}|{axes}", 0)


# ---------------------------------------------------------------------------
# The kernel as a custom op
# ---------------------------------------------------------------------------

def _lp(Bn=16, m=128, seed=0):
    rng = np.random.default_rng(seed)
    L = np.zeros((Bn, 4, m), np.float32)
    th = rng.uniform(0, 2 * np.pi, (Bn, m))
    L[:, 0], L[:, 1] = np.cos(th), np.sin(th)
    L[:, 2] = rng.uniform(-0.5, 1.0, (Bn, m))
    c = rng.standard_normal((Bn, 2)).astype(np.float32)
    mv = rng.integers(1, m + 1, (Bn, 1)).astype(np.int32)
    return torch.from_numpy(L), torch.from_numpy(c), torch.from_numpy(mv)


def test_rgb_op_on_the_cpu_is_rgb_plain_in_bits():
    L, c, mv = _lp()
    x, f = torch.ops.repro_torch.rgb(L, c, mv, 10.0, 8, 0)
    xp, fp = rgb_plain(L, c, mv, M=10.0, tile=8)
    assert x.numpy().tobytes() == xp.numpy().tobytes()
    assert torch.equal(f, fp) and f.dtype == torch.int32
    assert rgb_cuda.launches == 0  # the plain version launches nothing


def test_rgb_op_on_meta_gives_shapes_and_is_counted():
    L, c, mv = _lp(Bn=24)
    x, f = rgb_cuda(L.to("meta"), c.to("meta"), mv.to("meta"), M=10.0)
    assert (x.shape, x.dtype, f.shape, f.dtype) == (
        (24, 2), torch.float32, (24, 1), torch.int32)
    with pytest.raises(ValueError, match="multiple of tile"):
        rgb_cuda(L.to("meta"), c.to("meta"), mv.to("meta"), M=10.0, tile=16)
    got = count_call(lambda L, c, mv: rgb_cuda(L, c, mv, M=10.0), L, c, mv)
    assert got.ran_on == "meta"
    assert got.flops == int(rgb_flops(24, 128))
    # each input read once, each output written once
    assert got.bytes == 24 * (4 * 128 * 4 + 2 * 4 + 4 + 2 * 4 + 4)


def test_lp_clip_takes_the_kernel_on_meta_and_count_call_sees_it():
    cfg = _smoke("qwen2-0.5b")
    counts = {}
    fronts = (prep_cuda.launches, finish_cuda.launches)
    for clip in (False, True):
        opt = AdamW()
        prog = steps.make_train_step(cfg, HostMesh(torch.device("cpu")), opt,
                                     global_batch=2, lp_clip=clip)
        params = prog.model.init(torch.Generator().manual_seed(0))
        batch = {"tokens": torch.zeros((2, S), dtype=torch.int32),
                 "labels": torch.zeros((2, S), dtype=torch.int32)}
        counts[clip] = count_call(prog.step, params, opt.init(params), batch,
                                  {})
        assert counts[clip].ran_on == "meta"
    n_leaves = len(prog.model.param_shapes())
    tile = 8
    b_pad = -(-n_leaves // tile) * tile
    # the LP batch is (leaves padded to the tile) x 128 constraints
    assert counts[True].flops - counts[False].flops == int(
        rgb_flops(b_pad, 128))
    assert counts[True].bytes - counts[False].bytes > b_pad * 4 * 128 * 4
    # on meta the solve runs the eager front end: no prep, no finish
    assert (prep_cuda.launches, finish_cuda.launches) == fronts


# ---------------------------------------------------------------------------
# Record transport, RecordingMesh, LiveBytes
# ---------------------------------------------------------------------------

def test_recording_mesh_is_the_production_mesh_without_a_process_group():
    m = make_production_mesh(record=True)
    assert (m.axis_names, m.shape, m.world, m.backend) == (
        ("data", "model"), (16, 16), 256, "record")
    assert m.device.type == "meta" and m.rank == 0
    mp = make_production_mesh(multi_pod=True, record=True)
    assert (mp.axis_names, mp.shape, mp.world) == (
        ("pod", "data", "model"), (2, 16, 16), 512)
    r = RecordingMesh(("data", "model"), (4, 2), rank=5)
    assert r.coords == (2, 1) and r.group_ranks(("data",)) == [1, 3, 5, 7]
    assert r.index(("data",)) == 2 and r.group(("model",)) == ("model",)
    assert r.group(()) is None and r.size(("data", "model")) == 8


def test_record_transport_records_result_bytes_and_refuses_real_data():
    mesh = RecordingMesh(("data", "model"), (2, 4))
    x = torch.empty((8, 6), device="meta")
    D.reset_counts()
    assert D.psum(x, mesh, ("model",)).shape == (8, 6)
    assert D.all_gather(x, mesh, ("data", "model"), 0).shape == (64, 6)
    assert D._reduce_scatter(mesh, ("model",), x, 0).shape == (2, 6)
    assert D.ppermute(x, mesh, ("data",), [(0, 1), (1, 0)]).shape == (8, 6)
    q = torch.empty((5,), dtype=torch.int8, device="meta")
    assert D.psum_int8(q, mesh, ("data",)).dtype == torch.int32
    D.barrier(mesh)
    # counts: what each rank puts in; recorded: each call's result
    assert D.counts() == {
        "all_gather": {"calls": 1, "bytes": 192},
        "all_reduce": {"calls": 1, "bytes": 192},
        "ppermute": {"calls": 1, "bytes": 192},
        "psum_int8": {"calls": 1, "bytes": 5},
        "reduce_scatter": {"calls": 1, "bytes": 192}}
    assert D.coll_by_op(D.recorded()) == {
        "all-gather": 64 * 6 * 4 + 2 * 5, "all-reduce": 192,
        "collective-permute": 192, "reduce-scatter": 48}
    assert D.recorded()["all-gather"]["by_axes"] == {"data,model": 1536,
                                                     "data": 10}
    with pytest.raises(ValueError, match="meta tensors only"):
        D.psum(torch.ones(3), mesh, ("model",))
    # one rank along an axis: the identity, nothing recorded
    D.reset_counts()
    one = RecordingMesh(("data", "model"), (1, 1))
    assert D.psum(x, one, ("model",)) is x and D.recorded() == {}


def test_count_call_fills_coll_by_op_on_a_recording_mesh():
    mesh = RecordingMesh(("data", "model"), (2, 2))
    got = count_call(lambda t: D.psum(t @ t, mesh, ("model",)),
                     torch.ones(16, 16))
    assert got.coll_by_op == {"all-reduce": 16 * 16 * 4}
    assert got.flops == 2 * 16 ** 3


def test_live_bytes_is_the_high_water_of_live_storage():
    def fn(x):
        y = x * 2           # 4096 B (4000 rounded to 512)
        z = y + 1           # 4096 B
        del y
        w = z.view(10, 100)  # a view: no new storage
        return (w * 3).sum()  # 4096 B, then the 512-B sum; z still live

    x = torch.empty(1000, device="meta")
    got = count_meta(fn, (x,))
    assert got.peak_bytes == 3 * 4096 + 512  # x, z, w * 3 and the sum
    with LiveBytes((x,)) as lb:
        fn(x)
    assert lb.peak == got.peak_bytes and lb.live == 4096


# ---------------------------------------------------------------------------
# The dry run at full width
# ---------------------------------------------------------------------------

def _reference_keys():
    from repro.roofline import Roofline as RRoofline
    roof = RRoofline(flops=1.0, hbm_bytes=1.0, coll_bytes=1.0, chips=1,
                     model_flops=1.0)
    return set(roof.as_dict())


@pytest.mark.parametrize("shape,multi_pod", [
    ("train_4k", False), ("prefill_32k", False), ("decode_32k", False),
    ("long_500k", False), ("decode_32k", True)])
def test_dryrun_cell_qwen2_full_width(shape, multi_pod):
    if shape == "prefill_32k":  # the command line's cell, run alongside
        rec = _prefill_record()
    else:
        rec = dryrun.dryrun_cell("qwen2-0.5b", shape, multi_pod=multi_pod,
                                 peaks=H100, verbose=False)
    assert rec["peaks"] == H100 and rec["counted_on"] == "meta"
    if shape == "long_500k":  # full attention: not sub-quadratic
        assert rec["status"] == "skipped"
        assert {"arch", "shape", "multi_pod", "status", "reason"} <= set(rec)
        return
    assert rec["status"] == "ok"
    assert {"arch", "shape", "multi_pod", "chips", "status", "variant",
            "compile_s", "memory", "roofline"} <= set(rec)
    assert rec["chips"] == (512 if multi_pod else 256)
    mem = rec["memory"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "peak_bytes"}
    assert 0 < mem["argument_bytes"] < mem["peak_bytes"] < 80e9
    assert rec["fits"]
    roof = rec["roofline"]
    assert _reference_keys() <= set(roof)
    assert roof["peaks"]["memory_bytes"] == 80e9
    assert 0 < roof["useful_ratio"] <= 1
    assert 0 < roof["roofline_fraction"] <= 1
    # TP all-reduces on every cell; the logits gathered over the model axis
    assert roof["coll_by_op"]["all-reduce"] > 0
    assert roof["coll_by_op"]["all-gather"] > 0
    assert rec["kernel_calls"] == {}  # no LP clip on the baseline


def test_dryrun_lp_clip_variant_calls_the_kernel_once_a_step():
    rec = dryrun.dryrun_cell("qwen2-0.5b", "train_4k", peaks=H100,
                             step_kwargs={"lp_clip": True},
                             variant="lp-clip", probe=False, verbose=False)
    assert rec["variant"] == "lp-clip"
    assert rec["kernel_calls"] == {"repro_torch::rgb": 1}
    base = dryrun.dryrun_cell("qwen2-0.5b", "train_4k", peaks=H100,
                              probe=False, verbose=False)
    # qwen2-0.5b's 15 leaves pose a batch padded to 16 problems of 128
    assert rec["roofline"]["flops_per_dev"] - base["roofline"][
        "flops_per_dev"] == int(rgb_flops(16, 128))


def test_dryrun_lp_on_both_meshes():
    for mp in (False, True):
        rec = dryrun.dryrun_lp(multi_pod=mp, batch=1 << 13, m=128,
                               method="naive", peaks=H100)
        chips = 512 if mp else 256
        assert rec["status"] == "ok" and rec["chips"] == chips
        # x, feasible and objective gathered over every axis
        per = (1 << 13) // chips
        assert rec["collectives"] == {
            "all_gather": {"calls": 3, "bytes": per * (2 * 4 + 1 + 4)}}
        assert rec["roofline"]["coll_by_op"] == {
            "all-gather": (1 << 13) * (2 * 4 + 1 + 4)}
        assert rec["memory"]["argument_bytes"] == per * (128 * 3 + 2 + 1) * 4
        assert rec["roofline"]["model_flops"] == rgb_flops(1 << 13, 128)
        rgb = dryrun.dryrun_lp(multi_pod=mp, batch=1 << 13, m=128,
                               peaks=H100)
        assert rgb["status"] == "not_on_meta"
        assert "host" in rgb["reason"]


def test_main_writes_and_merges_records(tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    common = ["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--peaks",
              H100, "--out", str(out)]
    dryrun.main(common)
    dryrun.main(common + ["--multi-pod"])
    recs = json.loads(out.read_text())
    assert [(r["shape"], r["multi_pod"]) for r in recs] == [
        ("decode_32k", False), ("decode_32k", True)]
    dryrun.main(common)  # the same key again: replaced, not appended
    assert len(json.loads(out.read_text())) == 2
    assert "wrote 1 records" in capsys.readouterr().out


def test_no_card_and_no_peaks_is_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="--peaks"):
        dryrun.card_name(None)
    assert dryrun.card_name(H100) == H100


def test_the_dry_run_imports_nothing_of_jax():
    code = ("import sys, repro_torch.launch.dryrun; bad = [m for m in "
            "sys.modules if m == 'jax' or m.startswith('jax.') or m == "
            "'repro' or m.startswith('repro.')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


def test_every_shape_and_arch_is_in_the_sweep():
    assert len(ARCHS) * len(SHAPES) * 2 == 80
    n_skip = sum(1 for a in ARCHS.values() for s in SHAPES.values()
                 if not dryrun.applicable(a, s)) * 2
    assert n_skip == 16


# ---------------------------------------------------------------------------
# Against the reference's HLO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind,dtype", HLO_CASES,
                         ids=["/".join(c) for c in HLO_CASES])
def test_collectives_and_arguments_against_the_reference_hlo(arch, kind,
                                                             dtype):
    ref = _reference()[f"{arch}/{kind}/{dtype}"]
    coll = ref["coll"]
    port = _port(arch, kind, dtype)
    rec = port["rec"]
    model = port["model"]
    # an SSM's decode reads no positions, and jax.jit drops an unused
    # argument (keep_unused=False): the reference's bytes lack this
    # rank's two int32 positions
    unused = 4 * B // 2 if (kind, model.cfg.family) == ("decode",
                                                         "ssm") else 0
    assert port["arg"] == ref["arg"] + unused
    if dtype == "bfloat16":
        # the reference's CPU HLO carries bf16 activations as f32
        ref_ar = sum(v for k, v in coll.items() if k.startswith("all-reduce"))
        assert rec["all-reduce"]["bytes"] * 2 == ref_ar
        return
    if kind != "train":
        # all-reduces equal; the logits gathered over the data axes too
        for axes in ("model", "data", "data,model"):
            assert _axes(rec, "all-reduce", axes) == _ref_axes(
                coll, "all-reduce", "in", axes), axes
        assert _axes(rec, "all-gather", "model") == _ref_axes(
            coll, "all-gather", "in", "model")
        assert _axes(rec, "all-gather", "data") == B * model.v_pad * 4
        assert set(rec) == {"all-gather", "all-reduce"}
        return
    # the reference's train all-gathers are all its partitioner's
    assert not [k for k in coll if k.startswith("all-gather|in")]
    assert sum(v for k, v in coll.items() if k.startswith("all-gather")) > 0
    shapes = model.param_shapes()
    kv = sum(math.prod(shapes[p]) * 4 * 2 for p in model.kv_duplication())
    assert rec.get("all-gather", {"bytes": 0})["bytes"] == kv
    # data-axis gradient sums: within two f32 scalars
    ref_data = (_ref_axes(coll, "all-reduce", "in", "data")
                + _ref_axes(coll, "all-reduce", "in", "data,model"))
    assert abs(_axes(rec, "all-reduce", "data") - ref_data) <= 8
    # model axis: within 1 KiB once mamba2's B and C cotangent sums are out
    cfg = model.cfg
    bc = (cfg.n_layers * 2 * (B // 2) * S * cfg.ssm_state * 4
          if cfg.family == "ssm" else 0)
    ref_model = (_ref_axes(coll, "all-reduce", "in", "model")
                 + _ref_axes(coll, "all-reduce", "out", "model"))
    assert abs(_axes(rec, "all-reduce", "model") - bc - ref_model) <= 1024
