# Build entry points, mirroring the reference's four-target Makefile
# (reference Makefile:5-19: art/art64/artest/artest64).  Here the CLIs are
# Python entry points over one package; the native targets build the C++
# runtime library the hot host paths load via ctypes.

PY ?= python

.PHONY: all native golden test bench chip-smoke clean

all: native

# C++ runtime (quantize/biquad/byte-pack hot loops) -> art_jax/native/*.so
native:
	$(PY) -c "import art_jax.native as n; assert n.available(); print(n._LIB)"

# strict-IEEE golden harness from the read-only reference (out-of-tree)
golden:
	sh tools/build_golden.sh

test: native
	$(PY) -m pytest tests/ -q

bench: native
	$(PY) bench.py

# the main path once on one GPU at full width, checked against the host
# engines (exits nonzero with no result off a GPU)
chip-smoke:
	$(PY) chip_smoke.py

clean:
	rm -f art_jax/native/*.so
	find . -name __pycache__ -type d -exec rm -rf {} +
