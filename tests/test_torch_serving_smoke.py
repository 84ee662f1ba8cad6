"""``chip_smoke.py``'s serving phase, rehearsed on the CPU at a tiny config.

The phase only runs in full on the card; here it runs end to end on
``device="cpu"`` from a port-written checkpoint (the restore, the
teacher-forced, fp32 greedy and int8 checks, the timed run and its
``serving`` line), and it must fail when the paged forward is broken. Its
limits are the card's; its times mean nothing here.
"""

import json

import pytest
import torch

import chip_smoke
from pyrecover_tpu_torch.checkpoint.vanilla import save_ckpt_vanilla
from pyrecover_tpu_torch.config import TrainConfig
from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer
from pyrecover_tpu_torch.optim import build_optimizer
from pyrecover_tpu_torch.serving import paged
from pyrecover_tpu_torch.train_state import state_leaves

CFG = ModelConfig(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=256, max_seq_len=2048,
                  multiple_of=32)


@pytest.fixture()
def ckpt(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    model = Transformer(CFG, generator=torch.Generator().manual_seed(0))
    optimizer, _ = build_optimizer(TrainConfig(), model.parameters())
    path = tmp_path / f"ckpt_{chip_smoke.CKPT_STEPS}_final.ckpt"
    save_ckpt_vanilla(path, state_leaves(model, optimizer, step=chip_smoke.CKPT_STEPS),
                      verify=True, extra_meta={"step": chip_smoke.CKPT_STEPS})
    yield path
    torch.set_num_threads(threads)


def test_serving_phase_runs_on_the_cpu(ckpt, capsys):
    chip_smoke.serving_phase(ckpt, CFG, device="cpu")
    out = capsys.readouterr().out
    assert "FAIL" not in out
    line = next(x for x in out.splitlines() if x.startswith('{"serving"'))
    report = json.loads(line)["serving"]
    assert report["fp32_greedy"]["diverged"] == 0
    assert report["timed"]["engine_tokens_per_sec"] > 0
    assert report["resident_sequences_2048"]["int8"] > report["resident_sequences_2048"]["native"]


def test_serving_phase_fails_on_a_misplaced_kv_write(ckpt, monkeypatch, capsys):
    """Each position's keys and values written one slot late in the pool:
    the teacher-forced check must catch it, and the phase must exit
    non-zero."""
    real = paged._scatter_positions

    def late(tables, qpos, block_size):
        phys, off = real(tables, qpos, block_size)
        return phys, (off + 1) % block_size

    monkeypatch.setattr(paged, "_scatter_positions", late)
    with pytest.raises(SystemExit):
        chip_smoke.serving_phase(ckpt, CFG, device="cpu")
    out = capsys.readouterr().out
    assert "float32" in out and "FAILED: serving phase" in out
    assert "teacher-forced logits, float32" in out.split("FAILED")[1]
