# Mirrors the reference's Makefile targets (build/test/perf).

PYTHON ?= python

.PHONY: test perf smoke lint

test:
	$(PYTHON) -m pytest tests/ -q

# Need an NVIDIA GPU.
perf:
	$(PYTHON) bench.py

smoke:
	$(PYTHON) chip_smoke.py

lint:
	$(PYTHON) -m compileall -q sdfkit tests bench.py chip_smoke.py __graft_entry__.py
