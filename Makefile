CXX ?= g++
CXXFLAGS ?= -O3 -march=native -std=c++14 -Wall

.PHONY: all native test bench chip-smoke clean

all: native

native: native/libfastx.so native/cpu_baseline

native/libfastx.so: native/fastx_parser.cpp
	$(CXX) $(CXXFLAGS) -shared -fPIC -o $@ $<

native/cpu_baseline: native/cpu_baseline.cpp
	$(CXX) $(CXXFLAGS) -fopenmp -o $@ $<

# The tier-1 suite (ROADMAP.md "Tier-1 verify"), CPU only.
test:
	env JAX_PLATFORMS=cpu python -m pytest tests/ -q -m 'not slow' \
	    -p xdist -n 6 --dist loadfile -p no:randomly

bench:
	python bench.py

# On a GPU machine: the kernel compiled for the card vs the plain scan at
# real widths, and the CLI end to end, in one process (chip_smoke.py).
chip-smoke:
	python chip_smoke.py

clean:
	rm -f native/libfastx.so native/cpu_baseline
