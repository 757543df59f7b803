# Build the native host library (generator / host partitioner / scheduler)
# and run the test suite. The Python package builds the library lazily too,
# under a name keyed on a hash of its source; this target builds it ahead.

.PHONY: all native test bench chip-smoke clean

all: native

native:
	python -c "from icde2019_gpu_join import datagen; assert datagen.native_lib()"

test: native
	python -m pytest tests/ -x -q

bench: native
	python bench.py

# On-card gate: the engine's main path at real size on one GPU, bit-exact
# against the oracles (the CPU test suite cannot see device-only breakage).
chip-smoke: native
	python chip_smoke.py

clean:
	rm -f icde2019_gpu_join/datagen/native/libjoin_host-*.so
