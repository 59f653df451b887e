"""The recurrent-LM slice on a bf16 recurrentgemma-9b-smoke, the layers
of mixed dtype, with the settings of ``test_torch_recurrent_unlearn.py``
(see its docstring).

The bf16 model (``param_dtype="bfloat16"``: every RG-LRU layer holds its
f32 ``log_lambda`` beside bf16 weights, as the reference's init makes it)
must dampen each layer in one group call per dtype — two for an RG-LRU
layer, one elsewhere, one per layer of int8 codes — equal to the plain path
bit for bit, and forget (fp32 and int8 ssd) within the declared bf16
tolerance of the reference:

  * halting, checkpoints and MACs equal; the per-layer selection counts
    within 1% of the layer's parameters;
  * fp32: the edit masks agree on >= 98% of the entries; where both sides
    edited an entry, the values within 0.1 |theta| on all and 0.05 |theta|
    on >= 99% of them;
  * int8: the codes (on each swept leaf's own per-row scales) within one
    step on >= 98% of the entries.

The bf16 Fisher reproduces only to a few percent between two evaluation
orders of the reference itself: its eager (``jax.disable_jit``) and
compiled global Fisher of this model differ by more than 5% on 46% of the
entries (measured on the CPU), and the port's lies
between them. So selections flip near the threshold and beta moves by a
few percent; the tolerance is set at that level.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_recurrent_unlearn import (  # noqa: E402
    JRequest, JSpec, JUnlearner, _jax_tree, _layer_params, _same_bits,
    _setting, _spec, bridge, jcomp)

from repro_torch.api import ForgetRequest, Unlearner, UnlearnSpec  # noqa: E402
from repro_torch.core import ssd  # noqa: E402
from repro_torch.kernels import dampen as kd  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models.module import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim.compression import q8_quantize_tree  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def griffin_bf16():
    s = _setting("recurrentgemma-9b", dtype="bfloat16")
    fx, fy = s["sets"][0]
    out = {}
    for precision in ("fp32", "int8"):
        jp, jst = JUnlearner(s["jadapter"], s["jI"], _spec(
            JSpec, "ssd", precision=precision)).forget(
                JRequest(fx, fy), params=s["params"])
        tp, tst = Unlearner(s["tadapter"], s["tI"], _spec(
            UnlearnSpec, "ssd", precision=precision), device="cpu").forget(
                ForgetRequest(fx, fy), params=s["tparams"])
        out[precision] = (jp, jst, tp, tst)
    return s, out


def _is_rglru(s, j):
    return 0 < j < s["tadapter"].n_layers - 1 and \
        s["tcfg"].layer_types[j - 1] == "rglru"


def test_bf16_griffin_holds_an_f32_leaf_per_rglru_layer(griffin_bf16):
    s, _ = griffin_bf16
    ad = s["tadapter"]
    for j in range(ad.n_layers):
        dts = {k: t.dtype for k, t in bridge.paths(
            ad.get_layer(s["tparams"], j)).items()}
        f32 = [k for k, dt in dts.items() if dt == torch.float32]
        assert f32 == (["mixer/log_lambda"] if _is_rglru(s, j) else []), j
        assert all(dt == torch.bfloat16 for k, dt in dts.items()
                   if k not in f32), j


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_bf16_griffin_forgets_within_the_declared_tolerance(griffin_bf16,
                                                           precision):
    s, out = griffin_bf16
    jp, jst, tp, tst = out[precision]
    for k in ("stopped_at_l", "checkpoints_hit", "macs", "macs_ssd",
              "profile_S"):
        assert tst[k] == jst[k], k
    assert sorted(tst["selected_per_layer"]) == \
        sorted(jst["selected_per_layer"])
    for l, n_j in jst["selected_per_layer"].items():
        assert abs(tst["selected_per_layer"][l] - n_j) <= \
            1e-2 * _layer_params(s, l), l
    f32 = lambda t: {k: np.asarray(v, np.float32)  # noqa: E731
                     for k, v in _jax_tree(t).items()}
    if precision == "fp32":
        orig, want = f32(s["params"]), f32(jp)
        got = {k: v.float().numpy() for k, v in bridge.paths(tp).items()}
        agree = total = close = both_n = 0
        for k, w in want.items():
            ej, et = w != orig[k], got[k] != orig[k]
            agree += int((ej == et).sum())
            total += w.size
            both = ej & et
            d = np.abs(got[k] - w)[both]
            scale = np.abs(orig[k])[both]
            assert (d <= 0.1 * scale).all(), k
            close += int((d <= 0.05 * scale).sum())
            both_n += int(both.sum())
        assert agree >= 0.98 * total, (agree, total)
        assert close >= 0.99 * both_n, (close, both_n)
        return
    ad, jad = s["tadapter"], s["jadapter"]
    near = total = 0
    for j in range(ad.n_layers):
        want = f32(jad.get_layer(jp, j))
        got = {k: v.float().numpy() for k, v in bridge.paths(
            ad.get_layer(tp, j)).items()}
        scales = f32(jcomp.q8_quantize_tree(jad.get_layer(s["params"], j))[1])
        for k, w in want.items():
            d = np.abs(np.round(w / scales[k]) - np.round(got[k] / scales[k]))
            near += int((d <= 1).sum())
            total += d.size
    assert near >= 0.98 * total, (near, total)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_mixed_dtype_layer_dampens_one_group_call_per_dtype(griffin_bf16,
                                                            precision):
    """The card's path of ``dampen_tree_counted``, with the kernels replaced
    by their plain versions behind the wrapper's one-dtype-per-table rule:
    an RG-LRU layer of the bf16 model goes out as two tables (bf16 weights,
    the f32 log_lambda), every other layer as one; in int8 every layer is
    one table of codes. The leaves come back in the tree's order, equal to
    the plain path bit for bit, and the count is the masks' sum."""
    s, _ = griffin_bf16
    ad = s["tadapter"]
    calls = []

    def fake(ref):
        def launch(thetas, i_fs, i_gs, alpha, lam, outs=None):
            dts = {t.dtype for t in thetas}
            if len(dts) > 1:
                raise ValueError(f"a table of dtypes {dts}")
            calls.append(len(thetas))
            new, masks, n = ref(thetas, i_fs, i_gs, alpha, lam)
            if outs is not None:
                new = [o.copy_(t) for o, t in zip(outs, new)]
            return new, masks, n
        return launch

    gen = torch.Generator().manual_seed(3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kops, "_path", lambda name, t: "cuda")
        mp.setattr(kd, "dampen_group_cuda", fake(kd.dampen_group_ref))
        mp.setattr(kd, "dampen_int8_group_cuda",
                   fake(kd.dampen_int8_group_ref))
        for j in range(ad.n_layers):
            layer = ad.get_layer(s["tparams"], j)
            if precision == "int8":
                layer = q8_quantize_tree(layer)[0]
            i_g = ad.get_layer(s["tI"], j)
            i_f = tree_map(lambda g: torch.rand(g.shape, generator=gen)
                           * 12 * g, i_g)
            calls.clear()
            new, masks, n = ssd.dampen_tree_counted(
                precision, layer, i_f, i_g, 6.0, 0.5, use_kernel=True)
            want, want_m, _ = ssd.dampen_tree_counted(
                precision, layer, i_f, i_g, 6.0, 0.5, use_kernel=False)
            n_leaves = len(tree_leaves(layer))
            split = precision == "fp32" and _is_rglru(s, j)
            assert calls == ([n_leaves - 1, 1] if split else [n_leaves]), \
                (j, calls)
            _same_bits(new, want)
            _same_bits(masks, want_m)
            assert int(n) == sum(int(m.sum()) for m in tree_leaves(want_m))
