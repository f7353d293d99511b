"""The port's roofline arithmetic (``repro_torch.roofline``) against the JAX
reference's ``repro.roofline``.

The analytic estimates are the same arithmetic on the same configs, so they
are held equal exactly.  The :class:`Roofline` terms differ only by the
peaks (the H100's against the reference's TPU figures), so each is held to
the reference's scaled by the ratio of the two peaks (rtol 1e-12: one
division each).  ``count_call`` is checked on ops of known size (bytes
exact) and on the smoke Qwen2 forward + backward against the matrix-product
count ``chip_smoke.py::train_matmul_flops`` makes (1%).
"""
import dataclasses

import pytest
import torch

import repro.roofline as rr
from repro.configs import ARCHS as R_ARCHS
import _torch_compat  # noqa: F401  (this worker's torch threads)
from repro_torch import roofline as pr
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import MeshInfo, build_model
from repro_torch.tree import tree_leaves

H100 = "NVIDIA H100 80GB HBM3"
KINDS = ("train", "prefill", "decode")
# (batch, seq, tp, data): one card, and a sharded layout
LAYOUTS = ((8, 512, 1, 1), (256, 4096, 16, 16))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_estimates_equal_the_reference(arch):
    cfg, rcfg = ARCHS[arch], R_ARCHS[arch]
    for batch, seq, tp, data in LAYOUTS:
        for kind in KINDS:
            assert pr.fused_hbm_estimate(cfg, kind, batch, seq, tp, data) \
                == rr.fused_hbm_estimate(rcfg, kind, batch, seq, tp, data)
            assert pr.model_flops_estimate(cfg, kind, batch, seq) \
                == rr.model_flops_estimate(rcfg, kind, batch, seq)
        assert pr._cache_bytes(cfg, batch, seq, tp) \
            == rr._cache_bytes(rcfg, batch, seq, tp)


def test_peaks_for_the_h100_and_unknown_cards():
    p = pr.peaks_for(H100)
    assert (p.bf16_flops, p.f32_flops, p.f64_flops, p.hbm_bytes_s,
            p.link_bytes_s) == (989e12, 67e12, 34e12, 3.35e12, 450e9)
    for name in ("NVIDIA A100-SXM4-80GB", "TPU v5 lite", ""):
        with pytest.raises(KeyError):
            pr.peaks_for(name)


@pytest.mark.parametrize("hbm_fused", [0.0, 3.1e9])
def test_roofline_terms_are_the_references_scaled_by_the_peaks(hbm_fused):
    kw = dict(flops=4.2e13, hbm_bytes=7.5e10, coll_bytes=2.5e9, chips=4,
              model_flops=1.5e14, coll_by_op={"all-reduce": 2_500_000_000},
              hbm_fused=hbm_fused)
    ref = rr.Roofline(**kw)
    peaks = pr.peaks_for(H100)
    got = pr.Roofline(**kw, peaks=peaks)
    flop_r = rr.PEAK_FLOPS / peaks.bf16_flops
    hbm_r = rr.HBM_BW / peaks.hbm_bytes_s
    link_r = rr.LINK_BW / peaks.link_bytes_s
    approx = lambda v: pytest.approx(v, rel=1e-12)
    assert got.t_compute == approx(ref.t_compute * flop_r)
    assert got.t_memory == approx(ref.t_memory * hbm_r)
    assert got.t_memory_unfused == approx(ref.t_memory_unfused * hbm_r)
    assert got.t_collective == approx(ref.t_collective * link_r)
    assert got.useful_ratio == ref.useful_ratio
    scaled = {"compute": ref.t_compute * flop_r,
              "memory": ref.t_memory * hbm_r,
              "collective": ref.t_collective * link_r}
    assert got.bottleneck == max(scaled, key=scaled.get)
    assert got.roofline_fraction == approx(
        ref.model_flops / (4 * rr.PEAK_FLOPS) * flop_r
        / max(scaled.values()))
    d = got.as_dict()
    assert set(d) == set(ref.as_dict()) | {"peaks"}
    assert d["peaks"]["bf16_flops"] == 989e12
    built = pr.from_counts(kw["flops"], kw["hbm_bytes"], chips=4,
                           model_flops=kw["model_flops"], peaks=peaks,
                           coll_by_op=kw["coll_by_op"], hbm_fused=hbm_fused)
    assert built == got


def test_count_call_bytes_exact_on_known_ops():
    a = torch.ones(1000)
    b = torch.ones(1000)
    got = pr.count_call(torch.add, a, b)
    assert got.bytes == 3 * 1000 * 4 and got.flops == 0
    assert got.coll_by_op == {} and got.ran_on == "meta"
    x = torch.ones(64, 32, dtype=torch.bfloat16)
    w = torch.ones(32, 16, dtype=torch.bfloat16)
    got = pr.count_call(torch.matmul, x, w)
    assert got.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 2
    assert got.flops == 2 * 64 * 32 * 16
    # views move nothing
    assert pr.count_call(lambda t: t.t().unsqueeze(0)[:, 1:], x).bytes == 0


def test_count_call_falls_back_where_meta_cannot_run():
    x = torch.arange(6.0)
    got = pr.count_call(lambda t: (t * float(t.sum().item())).sum(), x)
    assert got.ran_on == "cpu"
    assert got.bytes > 0


def test_count_call_flops_of_the_smoke_qwen2_step():
    """chip_smoke.py::train_matmul_flops, written out: projections, MLP and
    head forward (2 per MAC), backward twice the forward, the attention
    score and value products, and under remat the blocks' forward again
    up to the last tensor the backward needs (torch's checkpoint stops
    before each block's down projection)."""
    cfg = dataclasses.replace(smoke_config(ARCHS["qwen2-0.5b"]),
                              dtype="float32")
    model = build_model(cfg, MeshInfo(), device="meta")
    params = model.param_tree()
    B, S = 2, 32
    toks = torch.zeros((B, S), dtype=torch.int32, device="meta")
    batch = {"tokens": toks, "labels": toks}

    def fwd_bwd(params, batch):
        with torch.enable_grad():
            loss, _ = model.loss(params, batch)
            return torch.autograd.grad(loss, tree_leaves(params))

    got = pr.count_call(fwd_bwd, params, batch)
    assert got.ran_on == "meta"
    lay = model.lay
    d, hd, f, Lr = cfg.d_model, cfg.hd, cfg.d_ff, cfg.n_layers
    v_pad = -(-cfg.vocab // 256) * 256
    block = d * (lay.h_pad + 2 * lay.kv_total) * hd + lay.h_pad * hd * d \
        + 3 * d * f
    attn = 2 * S * lay.h_pad * hd
    n = B * S
    fwd_blocks = 2 * n * Lr * (block + attn)
    fwd_head = 2 * n * v_pad * d
    assert cfg.remat
    remat = fwd_blocks - 2 * n * Lr * f * d
    want = 3 * (fwd_blocks + fwd_head) + remat
    assert got.flops == pytest.approx(want, rel=0.01)
