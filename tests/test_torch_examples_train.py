"""The port's train example (``examples/torch_train_then_forget.py``) on
the host (``--device cpu``) at a fifth of its steps (the card's
``[examples]`` phase runs it whole): run 1 journals its forget request and
finishes; run 2 resumes from the newest checkpoint (the last of run 1) and
trains on. The journal, and each run's start step, steps run and
stragglers, EQUAL the reference launcher's (``repro.launch.train.main``)
on the same arguments."""
import importlib.util
import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def reference_archs():
    """Every reference architecture registered: ``repro.configs`` fills its
    registry only where it is empty, and a test run earlier in this process
    may have imported a few of its config modules one by one."""
    jconfigs._load_all()


def example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the train example at a fifth of its steps (its batch and sequence): 40
# steps with checkpoints every 10 and the forget at 30, then a restart
# trained on to 44
TRAIN_CUT = dict(steps=40, resume_steps=44, unlearn_at=30, ckpt_every=10)


def test_train_resumes_after_the_journaled_forget():
    twin = example("torch_train_then_forget")
    out = twin.run("cpu", **TRAIN_CUT)
    first, second = twin.runs(**TRAIN_CUT)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        where = ["--ckpt-dir", ckpt_dir]
        want = {"run1": jtrain.main(first + where),
                "run2": jtrain.main(second + where),
                "journal": jckpt.journal_read(ckpt_dir)}
    assert out["journal"] == want["journal"]
    for run in ("run1", "run2"):
        for k in ("start_step", "steps_run", "stragglers"):
            assert out[run][k] == want[run][k], (run, k)
    run1, run2 = out["run1"], out["run2"]
    assert run1["start_step"] == 0 and run1["steps_run"] == 40
    assert run1["final_loss"] < run1["first_loss"]
    assert out["journal"] == [{"step": 30, "forget_domain": 2,
                               "mode": "ficabu"}]
    # the reference example's check, and where the resume stands exactly
    assert run2["start_step"] >= 30
    assert run2["start_step"] == 40 and run2["steps_run"] == 4
    assert run2["stragglers"] == 0
