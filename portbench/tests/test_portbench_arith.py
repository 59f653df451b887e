"""The yardstick's arithmetic against counts made by hand: the exact
percentile, the FLOP and byte counts, the card's peaks, the kernel
classes and the trace's reduction."""
from __future__ import annotations

import numpy as np
import pytest

from support_portbench import ROOT
from portbench.lib import bench, counts, peaks, stats, trace, traffic
from portbench.lib.config import Dims


def test_percentile_exact():
    v = [3.0, 1.0, 2.0, 10.0, 4.0]
    assert stats.percentile(v, 50) == 3.0
    assert stats.percentile(v, 100) == 10.0
    # rank 0.95 * 4 = 3.8 between 4.0 and 10.0
    assert stats.percentile(v, 95) == pytest.approx(4.0 + 0.8 * 6.0)
    assert stats.percentile(v, 95) == pytest.approx(np.percentile(v, 95))
    assert stats.percentile([7.0], 95) == 7.0


def test_peaks_of_the_card():
    h100 = peaks.peaks("NVIDIA H100 80GB HBM3")
    assert h100 == {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}
    with pytest.raises(KeyError):
        peaks.peaks("NVIDIA A100-SXM4-80GB")


TINY = Dims(n_layers=2, d_model=8, n_heads=2, n_kv_heads=1, head_dim=4,
            d_ff=12, vocab=16, rope_theta=1e4, rms_norm_eps=1e-6,
            qkv_bias=True, dtype="bfloat16")


def test_flops_by_hand():
    S = 6
    # a block: q 8x8, k and v 8x4, o 8x8, three 8x12: 2 * 320 per token;
    # attention 2 * H * dh * S = 2 * 2 * 4 * 6
    blk = 2 * (64 + 32 + 32 + 64 + 3 * 96) + 96
    head = 2 * 8 * 16
    assert counts.layer_forward_flops(TINY, 1, S) == blk
    assert counts.layer_forward_flops(TINY, 3, S) == head
    assert counts.layer_forward_flops(TINY, 0, S) == 0
    # 2 x 6 tokens, chunk 1, halted at l = 2 (the head and block 2), the
    # checkpoints l = 1 and 2 hit
    tok = 12
    p_head, p_blk = 8 + 8 * 16, 16 + 64 + 32 + 32 + 64 + 3 * 96 + 16
    assert counts.layer_params(TINY, 3) == p_head
    assert counts.layer_params(TINY, 2) == p_blk
    want = (tok * (2 * blk + head)              # the forward
            + 2 * tok * head + 2 * tok * blk     # two layers' backward
            + (2 * 2 + 4) * (p_head + p_blk)     # Fisher and dampening
            + tok * head + tok * (blk + head))   # checkpoints l = 1, 2
    assert counts.request_flops(TINY, 2, S, 1, 2, [1, 2]) == want
    # the rule's bytes: theta read and written (bf16), two f32 Fishers read
    assert counts.dampen_bytes(TINY, 2) == (p_head + p_blk) * 12
    assert sum(counts.layer_params(TINY, j) for j in range(4)) \
        == 16 * 8 + 2 * p_blk + p_head


@pytest.mark.parametrize("cell,params", [
    ("yi6b_ficabu_scanned", 1_908_477_952),
    ("qwen32b_ficabu_layerwise", 2_524_486_656),
])
def test_published_sizes(cell, params):
    dims = bench.load_cell(ROOT, cell).dims
    assert sum(counts.layer_params(dims, j)
               for j in range(dims.n_unlearn_layers)) == params


def test_kernel_classes_and_reduction():
    cls = trace.load_classes()
    assert trace.classify("void (anonymous namespace)::dampen_group_kernel<"
                          "__nv_bfloat16, Leaf, 64>(x)", cls) == "dampen"
    assert trace.classify("void cutlass::Kernel2<cutlass_80_simt_sgemm_256x1"
                          "28_8x4_nt_align1>(x)", cls) == "gemm"
    assert trace.classify("void at::native::reduce_kernel<512, 1>(x)",
                          cls) == "elementwise"
    ops = [("sgemm_a", 1.0, 2.0), ("copy", 1.5, 2.5),
           ("dampen_group_kernel", 4.0, 4.5)]
    red = trace.reduce_ops(ops, 0.5, 5.0, [(0.0, "forget"), (2.8, "sync")],
                           cls)
    assert red["busy_s"] == pytest.approx(2.0)
    assert red["by_class"]["dampen"] == pytest.approx(0.5)
    gaps = dict((n, s) for n, s in red["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(2.5)
    assert gaps["host sync, after dampen_group_kernel"] == pytest.approx(0.5)


def test_traffic_same_sizes_for_every_seed():
    cell = bench.load_cell(ROOT, "yi6b_ficabu_scanned").spec
    small = dict(cell, seq_len=16, data=dict(cell["data"], forget_pool=3))
    a = traffic.run_data(small, 2 ** 31 + 11)
    b = traffic.run_data(small, 2 ** 31 + 11)
    c = traffic.run_data(small, 12)
    assert (a.pool == b.pool).all() and a.pool.shape == c.pool.shape
    assert a.pool.shape == (3, 4, 16) and a.retain.shape == (4, 16)
    assert a.pool.max() < cell["data"]["vocab"]
