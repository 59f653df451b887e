"""The port's train launcher (``repro_torch.launch.train``) on the CPU, and
against the JAX package's (``repro.launch.train``).

  * twins of tests/test_launchers.py's train tests through ``main([...,
    "--device", "cpu"])``: learning with the mid-run forget (a checkpoint
    and a journal whose first record has ``forget_domain`` 2), resume after
    failure (a resumed run starts at step 10 and runs 4 steps),
    ``--compress int8``;
  * parity from the reference's own init (``init_lm(PRNGKey(0), cfg)``
    carried across by ``bridge.params_to_torch``), yi-6b-smoke, 10 steps,
    checkpoints every 5, the forget at step 10 (so that both periodic
    checkpoints survive ``gc_old(keep=2)``): the port's checkpoints at
    steps 5 and 10 against the reference's, npz entry by entry. The entry
    names, dtypes, shapes, ``opt/step``, ``ef`` (``{"_": 0}``) and META's
    ``step`` and ``data_step`` are EQUAL; every float leaf of ``params``,
    ``mu`` and ``nu`` lies within relative L2 TRAIN_RTOL of the reference's
    and within TRAIN_RTOL of its largest magnitude elementwise (both sides
    compute in f32, but the forward and backward sums run in other orders,
    ~1e-7, and ten Adam steps carry that; 3.7e-5 of the largest magnitude
    and 5e-6 relative L2 seen). The mid-run forget's ``stopped_at_l``,
    ``checkpoints_hit``, ``macs``, ``macs_ssd`` and ``macs_vs_ssd_pct``
    are EQUAL to the reference's, read from its ``Unlearner.forget``;
  * the reference's step-5 checkpoint, alone in a directory, resumes in
    the port's train, which writes step 10 within the same tolerances of
    the reference's step 10;
  * resume is exact within the port: on gemma3-1b-smoke in bf16, a run
    resumed from step 5 writes step 10 bit for bit as the uninterrupted
    run did (params stored as their f32 upcast, ``mu``, ``nu``, ``ef``,
    ``step``, ``data_step``), under deterministic algorithms, with
    ``--compress int8``.
"""
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import ckpt as JCKPT  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import ckpt as CKPT  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402

torch.set_num_threads(2)
TRAIN_RTOL = 1e-4
PARITY = ["--arch", "yi-6b", "--steps", "10", "--batch", "8", "--seq", "24",
          "--ckpt-every", "5", "--unlearn-at", "10"]
FORGET_KEYS = ("stopped_at_l", "checkpoints_hit", "macs", "macs_ssd",
               "macs_vs_ssd_pct")


# ---------------------------------------------------------------------------
# twins of tests/test_launchers.py
# ---------------------------------------------------------------------------
def test_train_smoke_with_unlearn(tmp_path):
    res = T.main([
        "--arch", "yi-6b", "--steps", "12", "--batch", "8", "--seq", "24",
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "5",
        "--unlearn-at", "8", "--lr", "3e-3", "--device", "cpu"])
    assert res["steps_run"] == 12
    assert res["final_loss"] < res["first_loss"]   # actually learning
    assert CKPT.latest_step(str(tmp_path)) is not None
    assert CKPT.journal_read(str(tmp_path))[0]["forget_domain"] == 2


def test_train_resume_after_failure(tmp_path):
    # run 1: 10 steps with a checkpoint at 5 and 10
    T.main(["--arch", "gemma3-1b", "--steps", "10", "--batch", "8",
            "--seq", "24", "--ckpt-dir", str(tmp_path), "--ckpt-every", "5",
            "--unlearn-at", "-1", "--device", "cpu"])
    # run 2: resume (simulates restart after node failure) and continue
    res = T.main(["--arch", "gemma3-1b", "--steps", "14", "--batch", "8",
                  "--seq", "24", "--ckpt-dir", str(tmp_path),
                  "--ckpt-every", "5", "--resume", "--unlearn-at", "-1",
                  "--device", "cpu"])
    assert res["start_step"] == 10
    assert res["steps_run"] == 4


def test_train_with_compression(tmp_path):
    res = T.main(["--arch", "yi-6b", "--steps", "10", "--batch", "8",
                  "--seq", "24", "--ckpt-dir", str(tmp_path),
                  "--compress", "int8", "--unlearn-at", "-1",
                  "--device", "cpu"])
    assert res["final_loss"] < res["first_loss"]


# ---------------------------------------------------------------------------
# parity with repro.launch.train
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """The reference's run (its forget's stats captured) and the port's run
    from the reference's init, in two directories."""
    base = tmp_path_factory.mktemp("train_parity")
    seen = []
    forget = japi.Unlearner.forget

    def spy(self, *a, **kw):
        out = forget(self, *a, **kw)
        seen.append(out[1])
        return out

    japi.Unlearner.forget = spy
    try:
        jres = jtrain.main(PARITY + ["--ckpt-dir", str(base / "j")])
    finally:
        japi.Unlearner.forget = forget
    jp = JLM.init_lm(jax.random.PRNGKey(0), jconfigs.get("yi-6b").smoke)
    p0 = bridge.params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    args = T.parse_args(PARITY + ["--ckpt-dir", str(base / "t"),
                                  "--device", "cpu"])
    run = T.train(T.build("yi-6b", True, 24), "cpu", args, params=p0)
    return {"base": base, "jres": jres, "jstats": seen, "run": run}


def _step(d, step):
    sd = d / f"step_{step:08d}"
    meta = json.loads((sd / "META.json").read_text())
    with np.load(sd / "host_0.npz") as z:
        return {k: z[k] for k in z.files}, meta


def _close_checkpoints(got_dir, want_dir, step):
    got, gmeta = _step(got_dir, step)
    want, wmeta = _step(want_dir, step)
    assert sorted(got) == sorted(want)
    for key in ("step", "data_step", "n_hosts"):
        assert gmeta[key] == wmeta[key], key
    assert gmeta["manifest"] == wmeta["manifest"]
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k.startswith(("opt__step", "ef__")) or w.dtype.kind != "f":
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        g64, w64 = g.astype(np.float64), w.astype(np.float64)
        rel = np.linalg.norm(g64 - w64) / max(np.linalg.norm(w64), 1e-30)
        assert rel <= TRAIN_RTOL, (k, rel)
        top = np.abs(w64).max()
        assert np.abs(g64 - w64).max() <= TRAIN_RTOL * top, k


@pytest.mark.parametrize("step", [5, 10])
def test_train_checkpoints_match_reference(parity, step):
    base = parity["base"]
    _close_checkpoints(base / "t", base / "j", step)
    assert int(parity["run"].opt.step) == 10
    assert CKPT.journal_read(str(base / "t")) == \
        JCKPT.journal_read(str(base / "j"))


def test_train_forget_matches_reference(parity):
    run = parity["run"]
    assert len(parity["jstats"]) == 1 and run.forget_stats is not None
    for key in FORGET_KEYS:
        assert run.forget_stats[key] == parity["jstats"][0][key], key
    assert run.result["steps_run"] == parity["jres"]["steps_run"] == 10
    for key in ("first_loss", "final_loss"):
        assert abs(run.result[key] - parity["jres"][key]) <= \
            TRAIN_RTOL * abs(parity["jres"][key]), key


def test_reference_checkpoint_resumes_in_port(parity, tmp_path):
    """The reference's step 5 alone in a directory: the port resumes it
    and reaches the reference's step 10."""
    src = parity["base"] / "j" / "step_00000005"
    shutil.copytree(src, tmp_path / src.name)
    argv = PARITY[:PARITY.index("--unlearn-at")] + [
        "--unlearn-at", "-1", "--resume", "--ckpt-dir", str(tmp_path),
        "--device", "cpu"]
    res = T.main(argv)
    assert res["start_step"] == 5 and res["steps_run"] == 5
    _close_checkpoints(tmp_path, parity["base"] / "j", 10)


def test_resume_is_exact_bf16(tmp_path):
    """Under deterministic algorithms a resumed run writes the same bits as
    the uninterrupted one: bf16 params, int8 codec state and all."""
    cfg = T.build("gemma3-1b", True, 16).with_(param_dtype="bfloat16")
    common = ["--steps", "10", "--batch", "4", "--seq", "16",
              "--ckpt-every", "5", "--compress", "int8", "--device", "cpu"]
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        full = T.train(cfg, "cpu", T.parse_args(
            common + ["--ckpt-dir", str(tmp_path / "a")]))
        shutil.copytree(tmp_path / "a" / "step_00000005",
                        tmp_path / "b" / "step_00000005")
        resumed = T.train(cfg, "cpu", T.parse_args(
            common + ["--ckpt-dir", str(tmp_path / "b"), "--resume"]))
    finally:
        torch.use_deterministic_algorithms(prev)
    assert resumed.result["start_step"] == 5
    assert all(np.isfinite(full.result[k])
               for k in ("first_loss", "final_loss"))
    assert full.params["embed"]["w"].dtype == torch.bfloat16
    a, ameta = _step(tmp_path / "a", 10)
    b, bmeta = _step(tmp_path / "b", 10)
    assert sorted(a) == sorted(b) and ameta["data_step"] == bmeta["data_step"]
    assert any(k.startswith("ef__") and np.abs(v).max() > 0
               for k, v in a.items())
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the manifest keeps the bf16 dtype of the params (stored as f32)
    dt = {m["path"]: m["dtype"] for m in ameta["manifest"]}
    assert dt["params/embed/w"] == "bfloat16" and dt["opt/mu/embed/w"] == \
        "float32" and dt["opt/step"] == "int32"
