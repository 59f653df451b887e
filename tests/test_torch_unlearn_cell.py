"""HC-3, ``repro_torch.launch.unlearn_cell``: its streamed programs (the
block's vjp, the squares, ``dampen_tree``) and its fused step
(``engine.build_fused_step``) at SMOKE size against the reference's
``jax.vjp`` / square / ``core.ssd.dampen_tree`` and its
``engine.build_fused_step``, with a tolerance per tensor; its analysis'
record; and its ``SPEC`` against the reference's. The reference's module
sets XLA_FLAGS at import, so its SPEC is read in a subprocess."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.ssd import dampen_tree as jdampen_tree
from repro.engine import build_fused_step as jbuild_fused_step
from repro.models import lm as JLM
from repro_torch import configs as tconfigs
from repro_torch.launch import unlearn_cell as UC
from repro_torch.models import lm as TLM
from repro_torch.models.module import tree_leaves, tree_map

torch.set_num_threads(2)
CARD = "NVIDIA H100 80GB HBM3"
N, S = 4, 16


def test_spec_matches_the_reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", "import json; from repro.launch import "
         "unlearn_cell as U; print(json.dumps(U.SPEC.to_dict()))"],
        capture_output=True, text=True, env=env, check=True, timeout=300)
    assert UC.SPEC.to_dict() == json.loads(out.stdout.splitlines()[-1])


@pytest.fixture(scope="module")
def cell():
    """yi-6b SMOKE's attention block, a forget chunk [N, S, D], its
    cotangent and a global Fisher, in both packages."""
    tcfg = tconfigs.get("yi-6b").smoke
    jcfg = jconfigs.get("yi-6b").smoke
    blk = TLM.init_block(torch.Generator().manual_seed(0), tcfg, "attn",
                         device="cpu")
    rng = np.random.default_rng(0)
    act = rng.standard_normal((N, S, tcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((N, S, tcfg.d_model)).astype(np.float32)
    jblk = tree_map(lambda t: jnp.asarray(t.numpy()), blk)
    pos = jnp.arange(S)[None].repeat(N, 0)

    def jlayer(b, a):
        return JLM.block_forward(b, jcfg, "attn", a, pos)[0]

    _, vjp = jax.vjp(jlayer, jblk, jnp.asarray(act))
    jg_blk, jg_act = vjp(jnp.asarray(cot))
    jfish = jax.tree_util.tree_map(lambda g: g.astype(jnp.float32) ** 2,
                                   jg_blk)
    # a global Fisher under the forget one: some entries pass alpha = 10
    fish_g = tree_map(lambda f: np.asarray(f) * rng.uniform(
        0, 0.3, f.shape).astype(np.float32), jfish)
    return {"tcfg": tcfg, "jcfg": jcfg, "blk": blk, "jblk": jblk,
            "act": act, "cot": cot, "jlayer": jlayer, "jg_blk": jg_blk,
            "jg_act": jg_act, "jfish": jfish, "fish_g": fish_g}


def _close(got, want, rtol, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _pairs(ttree, jtree):
    return zip(tree_leaves(ttree), tree_leaves(jtree))


def test_streamed_programs_match_the_reference(cell):
    c = cell
    grads = UC.grads_program(UC.layer_fn(c["tcfg"]))
    g_blk, g_act = grads(c["blk"], torch.as_tensor(c["act"]),
                         torch.as_tensor(c["cot"]))
    # f32 products in another summation order: rtol 1e-4 with an atol of
    # 1e-6 of each tensor's largest entry
    for (t, j) in _pairs(g_blk, c["jg_blk"]):
        _close(t, j, 1e-4, 1e-6 * float(np.abs(np.asarray(j)).max()))
    _close(g_act, c["jg_act"], 1e-4,
           1e-6 * float(np.abs(np.asarray(c["jg_act"])).max()))
    fish = UC.fimd_program(g_blk)
    for (t, j) in _pairs(fish, c["jfish"]):
        _close(t, j, 2e-4, 1e-6 * float(np.abs(np.asarray(j)).max()))
    # dampening on the reference's own Fisher pair: bit for bit
    jfish_np = tree_map(np.asarray, c["jfish"])
    new = UC.dampen_program(
        c["blk"], tree_map(torch.as_tensor, jfish_np),
        tree_map(torch.as_tensor, c["fish_g"]))
    jnew, jmasks = jdampen_tree(
        c["jblk"], c["jfish"], tree_map(jnp.asarray, c["fish_g"]),
        UC.SPEC.dampen.alpha, UC.SPEC.dampen.lam)
    assert int(sum(np.asarray(m).sum() for m in
                   jax.tree_util.tree_leaves(jmasks))) > 0
    for (t, j) in _pairs(new, jnew):
        assert np.array_equal(t.numpy(), np.asarray(j))


def test_fused_step_matches_the_reference(cell):
    """The fused step == the streamed programs bit for bit (the same vjp,
    squares and dampening), == the reference's ``dampen_tree`` on its
    Fisher bit for bit; against the reference's fused step the input
    cotangent within the vjp's tolerance and the selection count within
    the entries whose Fisher lies within 1% of alpha times the global
    one (the Fisher itself is held in the streamed test)."""
    c = cell
    layer = UC.layer_fn(c["tcfg"])
    acts_c = torch.as_tensor(c["act"])[None]
    cot_c = torch.as_tensor(c["cot"])[None]
    fish_g = tree_map(torch.as_tensor, c["fish_g"])
    new, g_acts, n_sel = UC.fused_program(layer)(
        None, c["blk"], fish_g, acts_c, cot_c, UC.scalars())
    g_blk, g_act = UC.grads_program(layer)(c["blk"], acts_c[0], cot_c[0])
    fish = UC.fimd_program(g_blk)
    streamed = UC.dampen_program(c["blk"], fish, fish_g)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(streamed), tree_leaves(new)))
    assert torch.equal(g_act, g_acts[0])
    alpha, lam = UC.SPEC.dampen.alpha, UC.SPEC.dampen.lam
    jon_port, _ = jdampen_tree(c["jblk"],
                               tree_map(lambda t: jnp.asarray(t.numpy()),
                                        fish),
                               tree_map(jnp.asarray, c["fish_g"]), alpha,
                               lam)
    for (t, j) in _pairs(new, jon_port):
        assert np.array_equal(t.numpy(), np.asarray(j))
    jstep = jbuild_fused_step(lambda ctx, b, a: c["jlayer"](b, a),
                              donate=None)
    _, jg_acts, jn = jstep(None, c["jblk"],
                           tree_map(jnp.asarray, c["fish_g"]),
                           jnp.asarray(c["act"])[None],
                           jnp.asarray(c["cot"])[None],
                           jnp.asarray([alpha, lam], jnp.float32))
    _close(g_acts, jg_acts, 1e-4,
           1e-6 * float(np.abs(np.asarray(jg_acts)).max()))
    near = sum(int((np.abs(np.asarray(f) - alpha * g)
                    <= 1e-2 * np.asarray(f)).sum())
               for f, g in zip(tree_leaves(c["jfish"]),
                               tree_leaves(c["fish_g"])))
    assert int(n_sel) > 0 and abs(int(n_sel) - int(jn)) <= near


def test_analysis_record(tmp_path):
    """The FULL cell's record: yi-6b's block, 64 x 4096 forget tokens on
    the 16 x 16 mesh, counted under FakeTensorMode (nothing allocated)."""
    res = UC.run(card=CARD, device="cpu")
    keys = {"flops", "bytes", "collective_bytes", "compute_s", "memory_s",
            "collective_s"}
    assert keys <= set(res["streamed"]) and keys <= set(res["fused"])
    assert {"speedup_memory_term", "cell", "spec"} <= set(res)
    assert res["rows_per_rank"] == 4 and res["card"] == CARD
    assert res["cell"] == "yi-6b CAU layer step, N=64 S=4096, 16x16"
    st = res["streamed"]
    parts = st["programs"]
    assert st["bytes"] > sum(p["bytes"] for p in parts.values())
    assert st["flops"] == parts["grads"]["flops"] == res["fused"]["flops"]
    assert res["fused"]["collective_bytes"] > 0
    assert res["speedup_memory_term"] == pytest.approx(
        st["memory_s"] / res["fused"]["memory_s"])
    with pytest.raises(ValueError, match="card="):
        UC.run(device="cpu")
