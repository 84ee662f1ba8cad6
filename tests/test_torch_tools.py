"""The port's operator CLIs held to the JAX package's ``tools/``, and the
fleet trace's redrive gap when a link goes away before a send.

* ``python -m pyrecover_tpu_torch.checkpoint.check_equality``: exit 0 on
  equal, 1 on different, 2 on an error, on pairs of one port state saved
  by each engine (vanilla, DCP, zerostall, in any mix) and of states moved
  past and within ``--tolerance``; ``--all-state`` sees the moments. On the
  vanilla pairs, which the JAX tool reads, its exit codes are JAX's.
* ``python -m pyrecover_tpu_torch.checkpoint.inspect``: ``--manifest`` and
  ``--reshard-plan --devices N [--mesh ...] --json`` on a port vanilla file
  print exactly what JAX's ``tools/inspect_checkpoint.py`` prints, exit
  codes included (1 where the preflight rejects the plan); the listing,
  the zerostall view, the manifest diff and the corrupt-file diagnosis run
  on the port's files.
* ``python -m pyrecover_tpu_torch.telemetry.summarize --json`` on a port
  trainer's stream writes the blob JAX's ``tools/summarize_telemetry.py``
  writes on that stream, and prints the same report.
* The redrive gap: a request dispatched to a replica whose link goes away
  between the dispatch and the send is redriven without a ``fleet_send``
  marker for its first attempt; its assembled trace still links both
  attempts and carries the hole in ``redrive_gap`` (it read 0.0 before the
  assembler started such an attempt at its dispatch).
"""

import json
import time

import numpy as np
import pytest
import torch

from pyrecover_tpu_torch import telemetry
from pyrecover_tpu_torch.checkpoint import check_equality, inspect
from pyrecover_tpu_torch.checkpoint.sharded import save_ckpt_sharded
from pyrecover_tpu_torch.checkpoint.vanilla import save_ckpt_vanilla
from pyrecover_tpu_torch.checkpoint.zerostall import save_ckpt_zerostall
from pyrecover_tpu_torch.config import TrainConfig
from pyrecover_tpu_torch.models.llama import ModelConfig, Transformer
from pyrecover_tpu_torch.optim import build_optimizer
from pyrecover_tpu_torch.telemetry import summarize, traceassembly
from pyrecover_tpu_torch.train_state import state_leaves

CFG = ModelConfig().tiny(vocab_size=64, compute_dtype="float32")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(seed=0):
    model = Transformer(CFG, generator=torch.Generator().manual_seed(seed))
    optimizer, _ = build_optimizer(TrainConfig(), model.parameters())
    return model, optimizer


def _save(engine, path, model, optimizer, step=5):
    leaves = state_leaves(model, optimizer, step=step)
    meta = {"step": step}
    if engine == "vanilla":
        save_ckpt_vanilla(path, leaves, extra_meta=meta)
    elif engine == "zerostall":
        save_ckpt_zerostall(path, leaves, extra_meta=meta, background=False)
    else:
        save_ckpt_sharded(path, leaves, extra_meta=meta)
    return path


NAMES = {"vanilla": "ckpt_5.ckpt", "zerostall": "ckpt_5.zs.json", "sharded": "ckpt_5"}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """One state saved by each engine (``a_*``), the same params with other
    moments (``moments``), params moved by 1e-3 (``far``) and by 5e-8
    (``near``), all vanilla but the engines' copies of ``a``."""
    d = tmp_path_factory.mktemp("equality")
    model, optimizer = _state()
    out = {}
    for engine, name in NAMES.items():
        (d / engine).mkdir()
        out[f"a_{engine}"] = _save(engine, d / engine / name, model, optimizer)
    # the same params, other moments
    leaves = state_leaves(model, optimizer, step=5)
    mu = next(leaf for leaf in leaves if ".mu[" in leaf.path or ".mu" in leaf.path)
    with torch.no_grad():
        mu.parts[0].add_(1.0)
    (d / "m").mkdir()
    out["moments"] = _save("vanilla", d / "m" / NAMES["vanilla"], model, optimizer)
    for label, delta in (("far", 1e-3), ("near", 5e-8)):
        moved, mopt = _state()
        with torch.no_grad():
            moved.layers[1].wo.add_(delta)
        (d / label).mkdir()
        out[label] = _save("vanilla", d / label / NAMES["vanilla"], moved, mopt)
    return out


def _port_rc(a, b, *flags):
    return check_equality.main([str(a), str(b), "--quiet", *flags])


def _jax_rc(a, b, *flags):
    import check_equality as jax_tool

    return jax_tool.main([str(a), str(b), "--quiet", *flags])


@pytest.mark.parametrize("a,b,flags,rc", [
    ("a_vanilla", "a_vanilla", (), 0),
    ("a_vanilla", "far", (), 1),
    ("a_vanilla", "near", (), 0),
    ("a_vanilla", "near", ("--tolerance", "1e-9"), 1),
    ("a_vanilla", "moments", (), 0),
    ("a_vanilla", "moments", ("--all-state",), 1),
    ("a_vanilla", "a_vanilla", ("--all-state",), 0),
])
def test_check_equality_exit_codes_equal_jax(pairs, a, b, flags, rc):
    assert _port_rc(pairs[a], pairs[b], *flags) == rc
    assert _jax_rc(pairs[a], pairs[b], *flags) == rc


@pytest.mark.parametrize("other", ["a_sharded", "a_zerostall"])
@pytest.mark.parametrize("flags", [(), ("--all-state",)])
def test_check_equality_reads_every_engine(pairs, other, flags):
    """A vanilla file and the DCP directory or zerostall manifest of the same
    state are equal, the whole state too; against the moved params not."""
    assert _port_rc(pairs["a_vanilla"], pairs[other], *flags) == 0
    assert _port_rc(pairs[other], pairs["a_vanilla"], *flags) == 0
    assert _port_rc(pairs[other], pairs["far"], *flags) == 1


def test_check_equality_errors_exit_2(pairs, tmp_path, capsys):
    assert _port_rc(pairs["a_vanilla"], tmp_path / "missing.ckpt") == 2
    junk = tmp_path / "junk.ckpt"
    junk.write_bytes(b"not a checkpoint")
    assert _port_rc(pairs["a_vanilla"], junk) == 2
    assert "ERROR" in capsys.readouterr().err


def test_check_equality_reports_the_largest_difference(pairs, capsys):
    assert check_equality.main([str(pairs["a_vanilla"]), str(pairs["far"])]) == 1
    out = capsys.readouterr().out
    assert "VALUE mismatch params.layers.wo" in out and out.rstrip().endswith("DIFFERENT")


def _tool_out(capsys, main, argv):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--manifest"],
    ["--reshard-plan", "--devices", "2", "--json"],
    ["--reshard-plan", "--devices", "4", "--mesh", "fsdp=2,tensor=2", "--json"],
    ["--reshard-plan", "--devices", "3", "--mesh", "tensor=3", "--json"],
    ["--reshard-plan", "--devices", "2", "--mesh", "pipeline=2"],
])
def test_inspect_equals_jax(pairs, capsys, argv):
    import inspect_checkpoint as jax_tool

    path = str(pairs["a_vanilla"])
    got = _tool_out(capsys, inspect.main, [path, *argv])
    want = _tool_out(capsys, jax_tool.main, [path, *argv])
    assert got == want
    if "tensor=3" in argv:
        assert got[0] == 1 and "SC11" in got[1]


def test_inspect_views_of_every_engine(pairs, capsys, tmp_path):
    assert inspect.main([str(pairs["a_vanilla"]), "--leaves"]) == 0
    out = capsys.readouterr().out
    assert "format: vanilla single-file (v2)" in out and "step: 5" in out
    assert ".params['layers']['wq']: float32 (2, 64, 64)" in out
    assert inspect.main([str(pairs["a_sharded"]), "--leaves"]) == 0
    assert "leaves: " in capsys.readouterr().out
    assert inspect.main([str(pairs["a_zerostall"]), "--chunks"]) == 0
    out = capsys.readouterr().out
    assert "zerostall manifest" in out and "MISSING" not in out
    assert inspect.main(["--diff-manifests", str(pairs["a_zerostall"]),
                         str(pairs["a_zerostall"]), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["changed_leaves"] == 0
    assert inspect.main(["--diff-manifests", str(pairs["a_vanilla"]),
                         str(pairs["a_zerostall"])]) == 2
    # a truncated copy: the diagnosis, exit 1
    cut = tmp_path / "ckpt_5.ckpt"
    data = pairs["a_vanilla"].read_bytes()
    cut.write_bytes(data[:len(data) // 2])
    assert inspect.main([str(cut)]) == 1
    out = capsys.readouterr().out
    assert "CORRUPT" in out and "intact leaf frames:" in out and "meta header intact" in out
    assert inspect.main([str(tmp_path / "none.ckpt")]) == 2


@pytest.fixture(scope="module")
def trainer_stream(tmp_path_factory):
    from pyrecover_tpu_torch import train

    d = tmp_path_factory.mktemp("stream")
    train.main(["--device", "cpu", "--training-steps", "4", "--batch-size", "2",
                "--sequence-length", "32", "--model-dim", "64", "--model-layers", "2",
                "--model-heads", "4", "--model-kv-heads", "2", "--vocab-size", "64",
                "--logging-frequency", "1", "--checkpoint-frequency", "2", "--telemetry",
                "--checkpoint-dir", str(d), "--experiment-name", "e"])
    return d / "e" / "e_telemetry.jsonl"


def test_summarize_equals_jax(trainer_stream, tmp_path, capsys):
    import summarize_telemetry as jax_tool

    got = _tool_out(capsys, summarize.main, [str(trainer_stream), "--json",
                                             str(tmp_path / "port.json")])
    want = _tool_out(capsys, jax_tool.main, [str(trainer_stream), "--json",
                                             str(tmp_path / "jax.json")])
    assert got[0] == want[0] == 0
    assert got[1].replace("port.json", "X") == want[1].replace("jax.json", "X")
    port, ref = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "jax"))
    assert port == ref and port["metric"] == "goodput_pct" and port["value"] > 0
    assert summarize.main([str(tmp_path / "empty.jsonl")]) == 2


# ---- the redrive gap of an attempt that was never sent -------------------------------


class _Link:
    def __init__(self):
        self.sent = []

    def send(self, msg):
        self.sent.append(msg)

    def close(self):
        pass


def test_an_unsent_attempt_keeps_its_redrive_gap():
    """The router dispatches a request to replica 0 under its lock; replica
    0's link goes away before the send; the request is redriven to replica 1
    without a send marker for attempt 1. Its trace links both attempts and
    ``redrive_gap`` holds the hole from attempt 1's dispatch to attempt 2's
    send (0.0 before the fix); ``route`` is the admission-to-dispatch time."""
    from pyrecover_tpu_torch.serving.fleet.router import FleetRouter

    sink = telemetry.MemorySink()
    telemetry.add_sink(sink)
    try:
        router = FleetRouter(max_inflight=4)
        links = {0: _Link(), 1: _Link()}
        router._links.update(links)
        router._outstanding.update({0: set(), 1: set()})
        # the link goes away between the dispatch and the send
        real_send_all = router._send_all

        def send_all(sends):
            if any(target == 0 for target, _ in sends):
                time.sleep(0.02)
                router._links.pop(0, None)
            real_send_all(sends)

        router._send_all = send_all
        assert router.submit({"rid": "r1", "prompt": [1, 2], "max_new_tokens": 2}) \
            == "dispatched"
        (msg,) = links[1].sent
        assert msg["trace"]["attempt"] == 2 and not links[0].sent
        router._on_message(1, {"type": "done", "rid": "r1", "tokens": [1, 2, 3, 4]})
    finally:
        telemetry.remove_sink(sink)
    sends = [e for e in sink.events if e["event"] == "fleet_send"]
    assert [e["attempt"] for e in sends] == [2]  # attempt 1 never reached a socket
    report = traceassembly.assemble([traceassembly.Domain("router", sink.events)])
    (entry,) = report["per_trace"].values()
    assert entry["attempts"] == 2
    assert entry["buckets"]["redrive_gap"] >= 0.015
    assert entry["buckets"]["route"] >= 0.0
    assert report["traces"]["orphan_spans"] == 0


def test_every_marked_stream_assembles_as_jax():
    """Where every attempt's send is marked, or none is, the assembler is
    JAX's: the fallback reads only a trace with a later attempt's send."""
    from pyrecover_tpu.telemetry import traceassembly as jax_traceassembly
    from test_torch_traceassembly import adversarial_streams

    for drop in (None, "fleet_send"):
        streams, _ = adversarial_streams(7)
        if drop:
            streams = {k: [e for e in v if e["event"] != drop] for k, v in streams.items()}
        got = traceassembly.assemble([traceassembly.Domain(k, [dict(e) for e in v])
                                      for k, v in streams.items()])
        want = jax_traceassembly.assemble([jax_traceassembly.Domain(k, [dict(e) for e in v])
                                           for k, v in streams.items()])
        assert got == want
    assert np.isfinite(got["traces"]["completed"])
