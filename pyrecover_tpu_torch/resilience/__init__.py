"""Resilience: checkpoint I/O retry and quarantine, the seeded fault plans
(``faults.py``), the goodput autopilot (``autopilot.py``) and the chaos
kill/resume soak that proves them against the trainer (``chaos.py``)."""
