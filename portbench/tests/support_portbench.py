"""Smoke cells and runs for the benchmark's tests (imported by name from
this folder; the fixtures are in ``conftest.py``)."""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

SMOKE = {
    # name: (qkv bias, KV heads, blocks, sweep mode, the real cell it copies)
    "yi_smoke": (False, 2, 3, "scanned", "yi6b_ficabu_scanned"),
    "qwen_smoke": (True, 4, 2, "layerwise", "qwen32b_ficabu_layerwise"),
}


def make_smoke_root(root: Path) -> Path:
    """``root`` as a checkout: BENCHMARK.json with the smoke cells added as
    files alone."""
    (root / "portbench" / "configs").mkdir(parents=True)
    (root / "portbench" / "workloads").mkdir(parents=True)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, (bias, kv, blocks, mode, real) in SMOKE.items():
        conf = {"hidden_size": 64, "intermediate_size": 160,
                "num_attention_heads": 4, "num_key_value_heads": kv,
                "head_dim": 16, "num_hidden_layers": blocks,
                "vocab_size": 256, "rope_theta": 10000.0,
                "rms_norm_eps": 1e-6, "qkv_bias": bias,
                "torch_dtype": "bfloat16"}
        (root / "portbench" / "configs" / f"{name}.json").write_text(
            json.dumps(conf))
        bench["configs"].append({
            "name": name, "source": "smoke", "reduced": [], "why": "smoke",
            "file": f"portbench/configs/{name}.json"})
        cell = json.loads(
            (ROOT / "portbench" / "workloads" / f"{real}.json").read_text())
        cell.update(config=name, traffic=f"{name}_traffic", tau=-1.0,
                    sweep_mode=mode, seqs_per_request=4, seq_len=32)
        # a SMOKE leaf holds 64 to 16384 elements, the reference selects
        # 1 to 2,000 of them: leaves count from 16 selections
        cell["min_selected"] = 16
        cell["data"].update(vocab=128, forget_pool=64)
        (root / "portbench" / "workloads" / f"cell_{name}.json").write_text(
            json.dumps(cell))
        bench["workloads"].append({
            "name": f"cell_{name}", "config": name,
            "traffic": f"{name}_traffic", "chips": 1, "why": "smoke"})
        for m in bench["per_layer"]:
            m["workloads"].append(f"cell_{name}")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_smoke(root: Path, cell: str, seed: int, *, precision="fp32",
              program=None, seconds=0.4):
    """One CPU run of a smoke cell through the harness, the card's check
    left out: (result line, check lines)."""
    import torch

    from portbench import run as R
    torch.set_num_threads(2)
    args = R.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                    str(seconds), "--trace", "0"])
    return R.measure(root, args, device="cpu", precision=precision,
                     program=program)
