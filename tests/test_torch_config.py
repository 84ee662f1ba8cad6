"""JAX launch lines parse in the port: ``--grad-quant-block``,
``--pp-microbatches``, ``--pp-schedule`` and ``--pp-virtual-stages`` take the
JAX package's defaults and validation and stay inert at ``--grad-allreduce
fp32`` and ``--pp 1``; at ``--pp`` above 1 they resolve to JAX's values, and
what JAX refuses beside the pipeline the port refuses with its words.
``--grad-allreduce bf16|int8`` and ``--optimizer-sharding zero1`` are ported
and validated as JAX validates them."""

import pytest

from pyrecover_tpu.config import build_parser as jax_build_parser
from pyrecover_tpu.config import get_args as jax_get_args
from pyrecover_tpu_torch.config import build_parser, get_args

FLAGS = ("grad_quant_block", "pp_microbatches", "pp_schedule", "pp_virtual_stages")
BASE = ["--model-dim", "64", "--model-layers", "2", "--model-heads", "4", "--model-kv-heads", "2",
        "--vocab-size", "128", "--sequence-length", "64", "--batch-size", "2"]


def test_defaults_equal_jax():
    port, ref = build_parser().parse_args([]), jax_build_parser().parse_args([])
    assert {f: getattr(port, f) for f in FLAGS} == {f: getattr(ref, f) for f in FLAGS}
    cfg = get_args(BASE + ["--device", "cpu"])
    assert (cfg.grad_quant_block, cfg.pp_microbatches, cfg.pp_schedule,
            cfg.pp_virtual_stages) == (256, 0, None, None)


@pytest.mark.parametrize("extra", [
    ["--grad-quant-block", "128"],
    ["--pp-microbatches", "8", "--pp-schedule", "gpipe"],
    ["--pp-schedule", "1f1b", "--pp-virtual-stages", "2", "--pp-microbatches", "4"],
    ["--grad-quant-block", "512", "--pp-microbatches", "2", "--pp-schedule", "1f1b",
     "--pp-virtual-stages", "1"],
])
def test_jax_launch_line_parses_inert(extra):
    """The same line in both packages: equal values, and the port's config
    builds (the flags act on nothing at fp32 and one stage)."""
    port = get_args(BASE + extra + ["--device", "cpu"])
    ref = jax_get_args(BASE + extra)
    for f in FLAGS:
        assert getattr(port, f) == getattr(ref, f), f
    assert port.grad_allreduce == "fp32" and port.pp == 1


@pytest.mark.parametrize("extra,match", [
    (["--grad-quant-block", "0"], "grad-quant-block must be positive"),
    (["--pp-virtual-stages", "2"], "requires --pp-schedule 1f1b"),
    (["--pp-schedule", "gpipe", "--pp-virtual-stages", "3"], "requires --pp-schedule 1f1b"),
    (["--pp-virtual-stages", "0", "--pp-schedule", "1f1b"], "must be >= 1"),
])
def test_invalid_values_raise_as_in_jax(extra, match):
    with pytest.raises(ValueError, match=match):
        get_args(BASE + extra + ["--device", "cpu"])
    with pytest.raises(ValueError):
        jax_get_args(BASE + extra)


@pytest.mark.parametrize("extra,item", [
    (["--pp", "2", "--pp-microbatches", "4", "--pp-schedule", "1f1b"], "item 8"),
    (["--grad-allreduce", "int8", "--grad-quant-block", "128"], "item 5"),
    (["--optimizer-sharding", "zero1"], "item 6"),
])
def test_acting_flags_raise_naming_the_roadmap_item(extra, item):
    """The pipeline (item 8), the quantized wire (item 5) and ZeRO-1 (item
    6) are ported: their lines parse to JAX's values, and what JAX's
    validation refuses is refused by both (beside the pipeline, the
    quantized wire, with JAX's words). The pipeline composes as JAX's:
    beside tensor, fsdp and ZeRO-1, beside the expert axis with an MoE
    model, and beside the sequence axis."""
    if item == "item 8":
        port, ref = get_args(BASE + extra + ["--device", "cpu"]), jax_get_args(BASE + extra)
        assert (port.pp, port.model.pp_microbatches, port.model.pp_schedule,
                port.model.pp_virtual_stages) == (ref.mesh.pipeline, ref.model.pp_microbatches,
                                                  ref.model.pp_schedule,
                                                  ref.model.pp_virtual_stages)
        for composed in (["--tp", "2", "--fsdp", "2", "--optimizer-sharding", "zero1"],
                         ["--ep", "2", "--moe-experts", "4"], ["--sp", "2"]):
            port = get_args(BASE + extra + composed + ["--device", "cpu"])
            ref = jax_get_args(BASE + extra + composed)
            assert (port.pp, port.tp, port.fsdp, port.ep, port.sp, port.optimizer_sharding,
                    port.model.n_experts, port.model.attention_impl) == (
                ref.mesh.pipeline, ref.mesh.tensor, ref.mesh.fsdp, ref.mesh.expert,
                ref.mesh.sequence, ref.optimizer_sharding, ref.model.n_experts,
                ref.model.attention_impl), composed
        lean = ["--grad-allreduce", "int8"]
        for get in (lambda a: get_args(a + ["--device", "cpu"]), jax_get_args):
            with pytest.raises(ValueError, match="does not compose with pipeline parallelism"):
                get(BASE + extra + lean)
        return
    port, ref = get_args(BASE + extra + ["--device", "cpu"]), jax_get_args(BASE + extra)
    for f in ("grad_allreduce", "grad_quant_block", "optimizer_sharding", "grad_bucket_mb"):
        assert getattr(port, f) == getattr(ref, f), f
    bad = {"item 5": ["--grad-quant-block", "0"], "item 6": ["--grad-bucket-mb", "-1"]}[item]
    with pytest.raises(ValueError):
        get_args(BASE + extra + bad + ["--device", "cpu"])
    with pytest.raises(ValueError):
        jax_get_args(BASE + extra + bad)


@pytest.mark.parametrize("kw,match", [
    (dict(optimizer_sharding="zorro"), "optimizer-sharding"),
    (dict(grad_allreduce="int4"), "grad-allreduce"),
    (dict(grad_quant_block=0), "quant-block"),
    (dict(grad_bucket_mb=-1), "bucket-mb"),
    (dict(grad_allreduce="int8", pp_schedule="1f1b"), "pipeline"),
    (dict(grad_bucket_mb=4, pp_schedule="1f1b"), "pipeline"),
])
def test_config_rejects_what_jax_rejects(kw, match):
    """JAX's ``test_config_rejects_bad_modes`` and
    ``test_config_rejects_bucket_compositions`` on the port's TrainConfig;
    buckets, zero1 and the int8 wire compose."""
    from pyrecover_tpu.config import TrainConfig as JaxTrainConfig
    from pyrecover_tpu_torch.config import TrainConfig

    with pytest.raises(ValueError, match=match):
        TrainConfig(device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        JaxTrainConfig(**kw)
    TrainConfig(device="cpu", grad_bucket_mb=4, optimizer_sharding="zero1",
                grad_allreduce="int8", dp=2)


def test_bad_schedule_choice_exits_in_both():
    for parse in (build_parser().parse_args, jax_build_parser().parse_args):
        with pytest.raises(SystemExit):
            parse(["--pp-schedule", "zb"])
