# cgx build/test/bench targets (the reference drives everything through a
# Makefile too — Makefile:7-30 — so the muscle memory carries over).

PY ?= python

.PHONY: all test test-fast test-gpu bench bench-quick native dryrun clean

all: native test

native:
	$(PY) -c "from cgx.native import lib; import sys; sys.exit(0 if lib() else 1)" \
	  && echo "native: OK" || echo "native: unavailable (pure-Python fallbacks active)"

test:
	$(PY) -m pytest tests/ -q

test-fast:
	$(PY) -m pytest tests/ -q -x -k "not reference_binary"

# On a machine with an NVIDIA GPU: the smoke run as a test.
test-gpu:
	$(PY) -m pytest tests/test_chip_smoke.py -q -m gpu

bench:
	$(PY) bench.py

bench-quick:
	$(PY) bench.py --quick

dryrun:
	$(PY) __graft_entry__.py dryrun 8

clean:
	rm -rf .pytest_cache cgx/native/_cgx_native.so $$(find . -name __pycache__ -type d)
