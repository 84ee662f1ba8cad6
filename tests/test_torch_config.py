"""JAX launch lines parse in the port: ``--grad-quant-block``,
``--pp-microbatches``, ``--pp-schedule`` and ``--pp-virtual-stages`` take the
JAX package's defaults and validation and stay inert at ``--grad-allreduce
fp32`` and ``--pp 1``; where they would act (``--pp`` above 1, a quantized
wire) the port raises ``NotImplementedError`` naming the ROADMAP item."""

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
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1, {item}"):
        get_args(BASE + extra + ["--device", "cpu"])


def test_bad_schedule_choice_exits_in_both():
    for parse in (build_parser().parse_args, jax_build_parser().parse_args):
        with pytest.raises(SystemExit):
            parse(["--pp-schedule", "zb"])
