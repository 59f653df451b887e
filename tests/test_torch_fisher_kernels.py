"""The port's fimd, gemm_fisher, gemm_fisher_int8 and dampen_int8_rowscale
wrappers against the JAX package's, on the CPU.

Here (no card) ``repro_torch.kernels.ops`` takes each kernel's plain PyTorch
version; the JAX side runs its Pallas kernels in interpret mode, as
tests/test_kernels.py does, and its pure-jnp oracles. The same numpy inputs
go to both, at test_kernels.py's own shapes. Tolerances: fimd rtol 1e-5
(f32) / 2e-2 (bf16) — a sum of positive squares in another order;
gemm_fisher test_kernels.py's rtol 1e-4 / 2e-2 with its atol (signed sums
cancel); gemm_fisher_int8 and dampen_int8_rowscale BIT-exact (an exact
integer sum and correctly rounded f32 steps). The CUDA kernels are held
against these plain versions on the card by chip_smoke.py.

Two ties to the main path, on a tiny ResNet-18 on the CPU: fimd of the
stacked per-chunk gradients over nc is the Fisher that the fused step's
``grad_fisher_chunks`` accumulates, and gemm_fisher on a layer's cached
input and output cotangent is the autograd weight gradient (the fc, and a
stride-2 conv through im2col, with chip_smoke.py's own im2col and conv
tape, so that the card's check and this one lay the conv out alike).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import adapters  # noqa: E402
from repro_torch.core.cau import _chunk, _logit_cotangents  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.engine.fused import grad_fisher_chunks  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import dampen as kdampen  # noqa: E402
from repro_torch.kernels import fimd as kfimd  # noqa: E402
from repro_torch.kernels import gemm_fisher as kgf  # noqa: E402
from repro_torch.kernels import gemm_fisher_int8 as kgf8  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import vision as V  # noqa: E402
from repro_torch.models.module import (tree_leaves,  # noqa: E402
                                       tree_unflatten)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

torch.set_num_threads(2)
RNG = np.random.default_rng(13)

PAIRS = [(2.0, 0.5), (10.0, 1.0), (0.5, 0.1), (0.5, 1.0)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _pair(x, dtype):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)


# -- fimd --------------------------------------------------------------------
@pytest.mark.parametrize("B,P", [(8, 1024), (16, 3000), (7, 130), (64, 4096),
                                 (1, 8192), (24, 1)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fimd_against_jax(B, P, dtype):
    g_t, g_j = _pair(RNG.normal(size=(B, P)).astype(np.float32), dtype)
    got = ops.fimd(g_t)
    assert got.dtype == torch.float32 and tuple(got.shape) == (P,)
    rtol = 2e-2 if dtype == "bfloat16" else 1e-5
    for want in (jops.fimd(g_j), jref.fimd_ref(g_j)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=rtol, atol=0)


def test_fimd_multidim_against_jax():
    g = RNG.normal(size=(8, 12, 34)).astype(np.float32)
    got = ops.fimd(torch.from_numpy(g))
    assert tuple(got.shape) == (12, 34)
    np.testing.assert_allclose(got.numpy(), _np(jops.fimd(jnp.asarray(g))),
                               rtol=1e-5, atol=0)


# -- gemm_fisher -------------------------------------------------------------
@pytest.mark.parametrize("N,M,K", [(128, 256, 256), (200, 300, 100),
                                   (256, 512, 384), (64, 64, 64)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gemm_fisher_against_jax(N, M, K, dtype):
    a_t, a_j = _pair(RNG.normal(size=(N, M)).astype(np.float32), dtype)
    g_t, g_j = _pair(RNG.normal(size=(N, K)).astype(np.float32), dtype)
    dw, fish = ops.gemm_fisher(a_t, g_t)
    assert dw.dtype == fish.dtype == torch.float32
    assert tuple(dw.shape) == tuple(fish.shape) == (M, K)
    assert torch.equal(fish, dw * dw)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4   # tests/test_kernels.py:80
    for dwr, fishr in (jops.gemm_fisher(a_j, g_j),
                       jref.gemm_fisher_ref(a_j, g_j)):
        np.testing.assert_allclose(dw.numpy(), _np(dwr), rtol=tol,
                                   atol=tol * 10)
        np.testing.assert_allclose(fish.numpy(), _np(fishr), rtol=2 * tol,
                                   atol=tol * 10)


# -- gemm_fisher_int8 --------------------------------------------------------
@pytest.mark.parametrize("N,M,K", [(64, 128, 128), (100, 200, 96),
                                   (32, 256, 384), (8, 64, 64)])
def test_gemm_fisher_int8_bit_exact_against_jax(N, M, K):
    a_q = RNG.integers(-127, 128, size=(N, M)).astype(np.int8)
    g_q = RNG.integers(-127, 128, size=(N, K)).astype(np.int8)
    sa = (np.abs(RNG.normal(size=(M,))) + 1e-3).astype(np.float32)
    sg = (np.abs(RNG.normal(size=(K,))) + 1e-3).astype(np.float32)
    dw, fish = ops.gemm_fisher_int8(*(torch.from_numpy(x)
                                      for x in (a_q, g_q, sa, sg)))
    assert dw.dtype == fish.dtype == torch.float32
    assert tuple(dw.shape) == (M, K)
    args = tuple(jnp.asarray(x) for x in (a_q, g_q, sa, sg))
    for dwr, fishr in (jops.gemm_fisher_int8(*args),
                       jref.gemm_fisher_int8_ref(*args)):
        np.testing.assert_array_equal(dw.numpy().view(np.uint32),
                                      np.asarray(dwr).view(np.uint32))
        np.testing.assert_array_equal(fish.numpy().view(np.uint32),
                                      np.asarray(fishr).view(np.uint32))


def test_gemm_fisher_int8_extreme_codes_stay_exact():
    """Every product at ±127·±127 (and a -128 code) over a long reduction:
    the float64 sum of the plain version is exact, as int32 is."""
    N = 4096
    a_q = np.full((N, 3), 127, np.int8)
    a_q[:, 1] = -128
    g_q = np.full((N, 2), -127, np.int8)
    dw, _ = ops.gemm_fisher_int8(torch.from_numpy(a_q), torch.from_numpy(g_q),
                                 torch.ones(3), torch.ones(2))
    assert dw[0, 0].item() == float(np.float32(-127 * 127 * N))
    assert dw[1, 0].item() == float(np.float32(128 * 127 * N))
    assert kgf8.MAX_N * 128 * 128 <= 2 ** 31 - 1


# -- dampen_int8_rowscale ----------------------------------------------------
@pytest.mark.parametrize("R,C", [(8, 1024), (13, 500), (64, 2048), (1, 7)])
@pytest.mark.parametrize("alpha,lam", PAIRS)
def test_dampen_int8_rowscale_bit_exact_against_jax(R, C, alpha, lam):
    thq = RNG.integers(-127, 128, size=(R, C)).astype(np.int8)
    i_fq = RNG.integers(0, 128, size=(R, C)).astype(np.int8)
    fs = (np.abs(RNG.normal(size=(R,))) + 1e-6).astype(np.float32)
    i_g = (np.abs(RNG.normal(size=(R, C))) + 1e-6).astype(np.float32)
    got = ops.dampen_int8_rowscale(*(torch.from_numpy(x) for x in
                                     (thq, i_fq, fs, i_g)), alpha, lam)
    assert got.dtype == torch.int8 and tuple(got.shape) == (R, C)
    args = tuple(jnp.asarray(x) for x in (thq, i_fq, fs, i_g))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.dampen_int8_rowscale(*args, alpha, lam)))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jref.dampen_int8_rowscale_ref(*args, alpha, lam)))
    # the same edit as dampen_int8 on the dequantised Fisher
    i_f = torch.from_numpy(i_fq).float() * torch.from_numpy(fs)[:, None]
    codes, _ = ops.dampen_int8(torch.from_numpy(thq), i_f,
                               torch.from_numpy(i_g), alpha, lam)
    assert torch.equal(got, codes)


# -- errors, counters, the library build ------------------------------------
def test_wrappers_raise_the_references_errors():
    """The ValueErrors of tests/test_kernels.py, with the same words, from
    the port's wrappers and (for the record) the reference's."""
    thq = torch.zeros(4, 8, dtype=torch.int8)
    i_fq = torch.zeros(4, 8, dtype=torch.int8)
    i_g = torch.ones(4, 8)
    with pytest.raises(ValueError, match="scale"):
        ops.dampen_int8_rowscale(thq, i_fq, torch.ones(3), i_g, 1.0, 1.0)
    with pytest.raises(ValueError, match="int8"):
        ops.dampen_int8_rowscale(thq.float(), i_fq, torch.ones(4), i_g, 1.0,
                                 1.0)
    with pytest.raises(ValueError, match=r"\[R, C\]"):
        ops.dampen_int8_rowscale(thq.reshape(-1), i_fq.reshape(-1),
                                 torch.ones(4), i_g.reshape(-1), 1.0, 1.0)
    with pytest.raises(ValueError, match="elementwise"):
        ops.dampen_int8_rowscale(thq, i_fq[:, :7], torch.ones(4), i_g, 1.0,
                                 1.0)
    a_q = torch.zeros(16, 32, dtype=torch.int8)
    g_q = torch.zeros(16, 24, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        ops.gemm_fisher_int8(a_q.float(), g_q, torch.ones(32), torch.ones(24))
    with pytest.raises(ValueError, match="scale"):
        ops.gemm_fisher_int8(a_q, g_q, torch.ones(31), torch.ones(24))
    with pytest.raises(ValueError, match="reduction"):
        ops.gemm_fisher_int8(a_q, torch.zeros(15, 24, dtype=torch.int8),
                             torch.ones(32), torch.ones(24))
    with pytest.raises(ValueError, match="reduction"):
        ops.gemm_fisher(torch.zeros(16, 32), torch.zeros(15, 24))
    with pytest.raises(ValueError, match="reduction"):
        ops.gemm_fisher(torch.zeros(16, 32, 1), torch.zeros(16, 24))
    with pytest.raises(ValueError, match="reduction"):
        jops.gemm_fisher(jnp.zeros((16, 32)), jnp.zeros((15, 24)))


def test_cpu_path_launches_no_kernel():
    """On the CPU every wrapper is its plain version: no launch counter
    moves, and each result is the plain version's, bit for bit."""
    counters = lambda: (kfimd.LAUNCHES, kgf.LAUNCHES, kgf8.LAUNCHES,  # noqa: E731
                        kdampen.ROWSCALE_LAUNCHES, kdampen.LAUNCHES,
                        kdampen.INT8_LAUNCHES)
    before = counters()
    g = torch.randn(8, 100)
    assert torch.equal(ops.fimd(g), ref.fimd_ref(g))
    a, gg = torch.randn(40, 30), torch.randn(40, 20)
    assert all(torch.equal(x, y) for x, y in
               zip(ops.gemm_fisher(a, gg), ref.gemm_fisher_ref(a, gg)))
    a_q = torch.randint(-127, 128, (40, 30), dtype=torch.int8)
    g_q = torch.randint(-127, 128, (40, 20), dtype=torch.int8)
    sa, sg = torch.rand(30), torch.rand(20)
    assert all(torch.equal(x, y) for x, y in
               zip(ops.gemm_fisher_int8(a_q, g_q, sa, sg),
                   ref.gemm_fisher_int8_ref(a_q, g_q, sa, sg)))
    thq = torch.randint(-127, 128, (6, 9), dtype=torch.int8)
    i_fq, fs, i_g = torch.rand(6, 9) * 127, torch.rand(6), torch.rand(6, 9)
    assert torch.equal(ops.dampen_int8_rowscale(thq, i_fq, fs, i_g, 2.0, 0.5),
                       ref.dampen_int8_rowscale_ref(thq, i_fq, fs, i_g, 2.0,
                                                    0.5))
    assert counters() == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """The ``*_cuda`` wrappers launch or raise; none falls back to its plain
    version (and none builds anything to get there)."""
    i8 = torch.zeros(4, 4, dtype=torch.int8)
    f = torch.zeros(4, 4)
    for call in (lambda: kfimd.fimd_cuda(f),
                 lambda: kgf.gemm_fisher_cuda(f, f),
                 lambda: kgf8.gemm_fisher_int8_cuda(i8, i8, torch.ones(4),
                                                    torch.ones(4)),
                 lambda: kdampen.dampen_int8_rowscale_cuda(
                     i8, f, torch.ones(4), f, 1.0, 1.0)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_build_tag_hashes_source_and_flags():
    """An edited source or a changed flag gives a new library name (so it
    rebuilds); the same pair gives the same name. No nvcc is run."""
    src = b"__global__ void k() {}"
    tag = kbuild.source_hash(src)
    assert tag == kbuild.source_hash(src, kbuild.NVCC_FLAGS)
    assert tag != kbuild.source_hash(src + b" ")
    assert tag != kbuild.source_hash(src, kbuild.NVCC_FLAGS + ("-G",))
    assert tag != kbuild.source_hash(
        src, tuple(f for f in kbuild.NVCC_FLAGS if f != "-O3"))
    assert kbuild.sources() == ["dampen", "fimd", "gemm_fisher",
                                "gemm_fisher_int8"]
    name = kbuild.library_path("fimd").name
    text = (kbuild.CSRC / "fimd.cu").read_bytes()
    assert name == f"libficabu_fimd-{kbuild.source_hash(text)}.so"
    assert "--use_fast_math" not in kbuild.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kbuild.NVCC_FLAGS


# -- ties to the main path on a tiny ResNet-18 -------------------------------
CS = 4          # chunk size


@pytest.fixture(scope="module")
def sweep():
    """A tiny random ResNet-18 on the CPU and, for every layer of an ssd
    sweep over a 16-image forget batch (back to front, as the engine walks
    it), the chunked input activations, the chunked output cotangents and
    the Fisher of ``grad_fisher_chunks``."""
    cfg = V.ResNetConfig(width=8, n_classes=6, img_size=16)
    params = V.init_resnet(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    x, y = syn.make_classification(syn.ClsDataConfig(
        n_classes=6, img_size=16, n_per_class=16, seed=0))
    x, y = torch.as_tensor(x[:16]), torch.as_tensor(y[:16])
    ad = adapters.resnet_adapter(cfg, device="cpu")
    with torch.no_grad():
        logits, acts = ad.forward_collect(params, x)
    cot = _logit_cotangents(ad.loss, _chunk(logits, CS), _chunk(y, CS))
    layers = {}
    for j in range(ad.n_layers - 1, -1, -1):
        lp = ad.get_layer(params, j)
        acts_c = _chunk(acts[j], CS)
        apply = lambda p, a, _j=j: ad.apply_layer(None, _j, p, a)  # noqa: E731
        fish, g_acts = grad_fisher_chunks(apply, lp, acts_c, cot,
                                          with_act_grad=j > 0)
        layers[j] = (lp, apply, acts_c, cot, fish)
        cot = g_acts
    return layers


def _chunk_grads(lp, apply, a, cot):
    """Autograd gradients of one chunk, in tree_leaves order."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(lp)]
    return torch.autograd.grad(apply(tree_unflatten(lp, leaves), a), leaves,
                               grad_outputs=cot)


def _close(got, want, *, rel_l2=1e-5, rtol=1e-4, atol_of_max=1e-4):
    """Signed sums: relative L2 and |d| <= rtol |ref| + atol_of_max max|ref|
    (a pure rtol fails on entries that cancel to near zero)."""
    d = (got.double() - want.double())
    assert float(d.norm() / want.double().norm()) <= rel_l2
    bound = rtol * want.double().abs() + atol_of_max * want.double().abs().max()
    assert bool((d.abs() <= bound).all())


def test_fimd_is_the_fused_steps_fisher(sweep):
    """ops.fimd over the nc stacked chunk gradients, over nc, equals the
    Fisher grad_fisher_chunks accumulates — every leaf of every layer."""
    n = 0
    for j, (lp, apply, acts_c, cot, fish) in sweep.items():
        per_chunk = [_chunk_grads(lp, apply, acts_c[i], cot[i])
                     for i in range(acts_c.shape[0])]
        for li, f in enumerate(tree_leaves(fish)):
            stack = torch.stack([g[li] for g in per_chunk])
            got = ops.fimd(stack) / acts_c.shape[0]
            assert got.shape == f.shape
            torch.testing.assert_close(got, f, rtol=1e-5, atol=0)
            n += 1
    assert n == 56


def test_gemm_fisher_is_the_fc_weight_gradient(sweep):
    """On the fc (j = 9), A = the pooled cached input, G = the logit
    cotangent: dW is the autograd gradient of fc/w, chunk by chunk, and
    fish its square."""
    lp, apply, acts_c, cot, _ = sweep[V.RESNET_N_LAYERS - 1]
    for i in range(acts_c.shape[0]):
        a = acts_c[i].mean(dim=(2, 3))
        dw, fish = ops.gemm_fisher(a, cot[i])
        gw = tree_unflatten(lp, _chunk_grads(lp, apply, acts_c[i],
                                             cot[i]))["w"]
        assert dw.shape == gw.shape == (8 * 8, 6)
        _close(dw, gw)
        assert torch.equal(fish, dw * dw)


def test_gemm_fisher_is_a_stride2_conv_weight_gradient(sweep):
    """blocks/2/conv1 (j = 3, stride 2, "SAME" pads (0, 1)): im2col of the
    conv's cached input against its output cotangent gives the OIHW
    autograd gradient of the conv weight."""
    lp, apply, acts_c, cot, _ = sweep[3]
    assert V._block_stride(2) == 2
    conv = V.conv2d
    for i in range(acts_c.shape[0]):
        with smoke.conv_tape(V) as tape:
            w = lp["conv1"].detach().requires_grad_(True)
            out = apply(dict(lp, conv1=w), acts_c[i])
            out.backward(cot[i])
        w1, x1, stride, y1 = tape[0]
        assert w1 is w and stride == 2 and x1.shape[2] == 2 * y1.shape[2]
        a, g = smoke.conv_operands(x1.detach(), y1.grad, w.shape[2:], stride)
        assert a.shape == (CS * 8 * 8, 8 * 9) and g.shape == (CS * 8 * 8, 16)
        dw, fish = ops.gemm_fisher(a, g)
        _close(smoke.oihw(dw, w.shape), w.grad)
        assert torch.equal(fish, dw * dw)
    assert V.conv2d is conv  # the tape puts the model's conv back
