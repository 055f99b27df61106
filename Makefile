# Convenience entry points (the package itself is pure pip/setuptools).

.PHONY: test gpu-check smoke bench

# full suite on the virtual 8-device CPU mesh (default CI gate)
test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -x -q

# the tests that need the card (they skip on other backends)
gpu-check:
	JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q

# end-to-end smoke of the main path on one GPU (see chip_smoke.py)
smoke:
	python chip_smoke.py

# one benchmark config on the GPU (one JSON line)
bench:
	python bench.py
