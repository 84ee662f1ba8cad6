"""The repo's analyzers over the port: concur, distcheck, obscheck and
faultcheck (strict) find nothing in pyrecover_tpu_torch.

The port's telemetry docstring catalog arms obscheck's cross-surface rules.
Its README table is the port section's ``| port event | ... |`` table: the
repo README's ``| event | ... |`` table is the JAX package's own and lists
every event of the reference, so it is read here under the port's header
instead (OB04 then compares the port's docstring with the port's table).
faultcheck reads ``resilience/faults.py``'s ``FAULT_SITES`` and the plan
literals under ``tests/`` as its drill corpus.
"""

from pathlib import Path

import pytest

from pyrecover_tpu.analysis import concur, distcheck, faultcheck, obscheck

REPO = Path(__file__).resolve().parent.parent
PORT = str(REPO / "pyrecover_tpu_torch")
PORT_HEADER = "| port event | fields | emitted by |"


def port_readme_table():
    """The README's port event table, under the header obscheck reads."""
    lines = (REPO / "README.md").read_text(encoding="utf-8").splitlines()
    start = lines.index(PORT_HEADER)
    table = ["| event | fields | emitted by |"]
    for line in lines[start + 1:]:
        if not line.startswith("|"):
            break
        table.append(line)
    return "\n".join(table) + "\n"


def _show(result):
    return "\n".join(f"{f.path}:{f.line} {f.rule_id} {f.message}" for f in result.unsuppressed)


@pytest.mark.parametrize("tool", ["concur", "distcheck", "faultcheck"])
def test_analyzer_finds_nothing_in_the_port(tool):
    result = {"concur": concur, "distcheck": distcheck,
              "faultcheck": faultcheck}[tool].analyze_paths([PORT])
    assert result.unsuppressed == [], _show(result)


def test_obscheck_finds_nothing_in_the_port_against_its_own_tables():
    table = port_readme_table()
    assert table.count("\n") > 40  # the port's events, one row each
    result = obscheck.analyze_paths([PORT], obscheck.ObsConfig(readme_text=table))
    assert result.unsuppressed == [], _show(result)
    model = obscheck.build_model([PORT])
    # the catalog is armed: every emitted literal event name is catalogued
    assert model.cross_surface_armed
    assert set(model.sites_by_event) - {None} <= set(model.doc_catalog)


def test_faultcheck_sees_every_site_seamed_and_drilled():
    from pyrecover_tpu_torch.resilience.faults import FAULT_SITES

    model = faultcheck.build_model([PORT])
    assert set(model.registry) == set(FAULT_SITES)
    seamed = {s.site for s in model.seams}
    assert seamed == set(FAULT_SITES)
    drillable = {s for s, meta in FAULT_SITES.items() if meta["kind"] != "counter"}
    assert drillable <= model.drilled_sites()
