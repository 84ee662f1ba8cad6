"""Resumes across composed topologies through the port's ``train.main`` on
four gloo ranks: a pipeline beside the tensor or fsdp axis, and an MoE
model over the sequence axis, each checkpoint resumed where that axis is
gone.

* The tiny model (fp32 compute) at ``--pp 2 --tp 2`` with the sharded
  engine (each stage's tensor slices written by their ranks), its step-2
  checkpoint resumed at pp 1 (``--dp 4``) and at the tensor axis alone
  (``--tp 2 --dp 2``); at ``--pp 2 --fsdp 2`` with the vanilla engine
  (host 0 writes the stages' slices gathered whole), resumed at the fsdp
  axis alone (``--fsdp 2 --dp 2``); the MoE model at ``--sp 2 --dp 2``
  (vanilla), resumed at sp 1 (``--dp 4``). Steps 3-4 of each resume within
  ``RESUME_RTOL`` (1e-5) of the straight run's, one ``elastic_resume``
  event from the composed mesh, and ``sampler_rescaled`` from the saved
  data x fsdp to the live one, with ``--elastic-resume on``.
* The composed straight runs train the run ``--dp 4`` trains, their evals
  too (the pipeline's forward over a stage's tensor or fsdp slices; a
  sequence rank's columns with the rows routed whole), within 1e-5.

``python tests/test_torch_compose_resume.py drift`` prints the bf16 drift
of the composed legs (an MoE model over an interleaved pipeline with full
remat, an MoE model at sp 2, and pp 2 beside fsdp, tensor
and ZeRO-1) against one process, that ``chip_smoke.py``'s PMI, SM2, PF, PT
and PZ limits are set from.

Worker processes run this file as a script (``python tests/... worker``):
they import torch and the port only.
"""

import json
import sys

import pytest
import torch

from test_torch_distributed import spawn as _spawn
from test_torch_sp_pp_resume import EVAL, RESUME_RTOL, TINY, events, rel

MOE = ["--moe-experts", "4", "--moe-top-k", "2"]


def spawn(mode, args, **kw):
    return _spawn(__file__, mode, args, **kw)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def resume(d, saved, ckpt, *target):
    return ["--checkpoint-frequency", "0", "--elastic-resume", "on", *target,
            "--resume-from-checkpoint", str(d / saved / ckpt)]


@pytest.fixture(scope="module")
def resumes(tmp_path_factory):
    """The composed straight runs and their references, then each composed
    step-2 checkpoint resumed at the single-axis topologies, in one group of
    four ranks."""
    d = tmp_path_factory.mktemp("compose_resume")
    every2 = ["--checkpoint-frequency", "2", *EVAL]
    plan = [
        ("dp4", ["--dp", "4", "--checkpoint-frequency", "0", *EVAL]),
        ("pp2tp2", ["--pp", "2", "--tp", "2", "--checkpoint-engine", "sharded", *every2]),
        ("pp2fsdp2", ["--pp", "2", "--fsdp", "2", *every2]),
        ("moedp4", ["--dp", "4", "--checkpoint-frequency", "0", *MOE, *EVAL]),
        ("moesp2", ["--sp", "2", "--dp", "2", *MOE, *every2]),
        ("pp2tp2_to_pp1", resume(d, "pp2tp2", "ckpt_2", "--dp", "4")),
        ("pp2tp2_to_tp2", resume(d, "pp2tp2", "ckpt_2", "--tp", "2", "--dp", "2")),
        ("pp2fsdp2_to_fsdp2", resume(d, "pp2fsdp2", "ckpt_2.ckpt", "--fsdp", "2", "--dp", "2")),
        ("moesp2_to_sp1", resume(d, "moesp2", "ckpt_2.ckpt", "--dp", "4", *MOE)),
    ]
    return d, spawn("plan", {"dir": str(d), "plan": plan}, world=4, timeout=300)


@pytest.mark.parametrize("saved,target,axes,replicas", [
    ("pp2tp2", "pp1", {"pipeline": (2, 1), "tensor": (2, 1)}, (1, 4)),
    ("pp2tp2", "tp2", {"pipeline": (2, 1), "tensor": (2, 2)}, (1, 2)),
    ("pp2fsdp2", "fsdp2", {"pipeline": (2, 1), "fsdp": (2, 2)}, (2, 4)),
    ("moesp2", "sp1", {"sequence": (2, 1)}, (2, 4))])
def test_composed_checkpoint_resumes_at_one_axis(resumes, saved, target, axes, replicas):
    d, outs = resumes
    straight = outs[0][saved]["losses"]
    name = f"{saved}_to_{target}"
    for out in outs:
        resumed = out[name]
        assert resumed["start_step"] == 2 and rel(resumed["losses"], straight[2:]) <= RESUME_RTOL
    (e,) = events(d, name, "elastic_resume")
    for axis, (was, now) in axes.items():
        assert e["saved_topology"]["mesh"][axis] == was, axis
        assert e["target_topology"]["mesh"][axis] == now, axis
    assert [(r["saved_replicas"], r["target_replicas"])
            for r in events(d, name, "sampler_rescaled")] == [replicas]


@pytest.mark.parametrize("name,ref", [("pp2tp2", "dp4"), ("pp2fsdp2", "dp4"),
                                      ("moesp2", "moedp4")])
def test_composed_meshes_train_and_evaluate_the_same_run(resumes, name, ref):
    _, outs = resumes
    assert rel(outs[0][name]["losses"], outs[0][ref]["losses"]) <= RESUME_RTOL
    if name.startswith("moe"):  # the aux a step, each row's counted once
        assert rel(outs[0][name]["moe_aux"], outs[0][ref]["moe_aux"]) <= RESUME_RTOL
    for out in outs:
        got, want = out[name]["evals"], outs[0][ref]["evals"]
        assert [e["step"] for e in got] == [e["step"] for e in want] == [2, 4]
        assert rel([e["loss"] for e in got], [e["loss"] for e in want]) <= RESUME_RTOL


# ---- worker side -----------------------------------------------------------------------


def _plan_worker(args):
    """Every run of the plan through ``train.main`` in this group (joined
    once)."""
    from pyrecover_tpu_torch import train
    from pyrecover_tpu_torch.parallel import mesh

    mesh.initialize_distributed(required=True, device_type="cpu")
    out = {}
    for name, extra in args["plan"]:
        sm = train.main(TINY + ["--distributed", "--checkpoint-dir", args["dir"],
                                "--experiment-name", name, *extra])
        out[name] = {"losses": sm["losses"], "start_step": sm["start_step"],
                     "evals": sm.get("evals"), "moe_aux": sm.get("moe_aux")}
    mesh.destroy_distributed()
    return out


# the drift legs: (name, world, flags, the one-process reference's flags, the
# MoE dispatch both run, whether the leg routes each sequence chunk as a row)
DRIFT = ["--device", "cpu", "--sequence-length", "128", "--batch-size", "4",
         "--training-samples", "16", "--model-dim", "128", "--model-layers", "4",
         "--model-heads", "4", "--model-kv-heads", "2", "--vocab-size", "256",
         "--training-steps", "4", "--learning-rate", "3e-4", "--lr-warmup-steps", "2",
         "--logging-frequency", "1", "--checkpoint-frequency", "0"]
DRIFT_MOE = ["--moe-experts", "4", "--moe-top-k", "2"]
DRIFT_PMI = [*DRIFT_MOE, "--remat", "--remat-policy", "full"]
# chip_smoke.py's SM legs: capacity binds, so the row's first-come order decides
DRIFT_SM = [*DRIFT_MOE, "--moe-capacity-factor", "0.5"]
DRIFT_LEGS = [
    ("pmi", 2, ["--pp", "2", "--pp-schedule", "1f1b", "--pp-microbatches", "4",
                "--pp-virtual-stages", "2", *DRIFT_PMI], DRIFT_PMI, "einsum", False),
    ("sm2", 2, ["--sp", "2", *DRIFT_SM], DRIFT_SM, "scatter", False),
    ("smc", 2, ["--sp", "2", *DRIFT_SM], DRIFT_SM, "scatter", True),
    ("pf", 4, ["--pp", "2", "--fsdp", "2", "--pp-schedule", "1f1b", "--pp-microbatches", "2"],
     [], None, False),
    ("pt", 4, ["--pp", "2", "--tp", "2", "--pp-schedule", "1f1b", "--pp-microbatches", "4",
               "--pp-virtual-stages", "2"], [], None, False),
    ("pz", 4, ["--pp", "2", "--dp", "2", "--optimizer-sharding", "zero1"], [], None, False),
]


def _drift_run(name, argv, dispatch, per_chunk):
    """One drift run through ``train.main`` with the MoE ``dispatch`` set in
    code (as the chip check's harness sets it) and, with ``per_chunk``, each
    sequence chunk routed as a row of its own."""
    import dataclasses

    from pyrecover_tpu_torch import train
    from pyrecover_tpu_torch.models import moe

    build, seq_ctx = train.build_model, moe._seq_ctx
    if dispatch:
        train.build_model = lambda config, device: build(dataclasses.replace(
            config, model=dataclasses.replace(config.model, moe_dispatch=dispatch)), device)
    if per_chunk:
        moe._seq_ctx = lambda mesh: None
    try:
        sm = train.main(DRIFT + ["--experiment-name", name, *argv])
    finally:
        train.build_model, moe._seq_ctx = build, seq_ctx
    return {k: sm[k] for k in ("losses", "grad_norms", "moe_aux")}


def _drift_worker(args):
    """The drift legs of this group's size on this rank (bf16 compute)."""
    from pyrecover_tpu_torch.parallel import mesh

    mesh.initialize_distributed(required=True, device_type="cpu")
    out = {name: _drift_run(name, ["--distributed", "--checkpoint-dir", args["dir"], *extra],
                            dispatch, per_chunk)
           for name, world, extra, _, dispatch, per_chunk in DRIFT_LEGS
           if world == mesh.world_size()}
    mesh.destroy_distributed()
    return out


def drift_main():
    """``python tests/test_torch_compose_resume.py drift``: a small model at
    bf16 compute on gloo ranks (the composed legs, `DRIFT_LEGS`) against one
    process, each step's relative loss and aux difference and step 1's
    gradient norm's (the chip check's PMI, SM2, PF, PT and PZ limits are set
    from these; SMC, SM2 with each chunk routed as a row, is the plant that
    must miss them)."""
    import tempfile
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # run as a script
    torch.set_num_threads(1)

    def rels(a, b):
        return [abs(x - y) / abs(y) if y else abs(x) for x, y in zip(a, b)]

    out = {}
    with tempfile.TemporaryDirectory() as d:
        legs = {}
        for world in (2, 4):
            legs.update(spawn("drift", {"dir": d}, world=world, timeout=900)[0])
        for name, _, _, ref_flags, dispatch, _ in DRIFT_LEGS:
            one = _drift_run(f"{name}1", ["--checkpoint-dir", d, *ref_flags], dispatch, False)
            leg = legs[name]
            out[name] = {"loss": rels(leg["losses"], one["losses"]),
                         "aux": rels(leg["moe_aux"], one["moe_aux"]),
                         "step1_grad_norm": rels(leg["grad_norms"][:1], one["grad_norms"][:1])[0]}
    print(json.dumps({"composed_bf16_drift_vs_one_process": out}), flush=True)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    workers = {"plan": _plan_worker, "drift": _drift_worker}
    result = workers[sys.argv[2]](json.loads(sys.argv[3]))
    print(json.dumps(result), flush=True)
elif __name__ == "__main__" and sys.argv[1:2] == ["drift"]:
    drift_main()
