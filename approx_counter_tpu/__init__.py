"""Approximate k-mer counting engine for the GPU, in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
qbonenfant/approx_counter (the C++/SeqAn ``adaptFinder`` tool behind
Porechop_ABI's nanopore adapter inference): FASTA/FASTQ read-end sampling,
DUST low-complexity + forbidden-k-mer filtering, exact k-mer counting with
top-N / solid selection, and edit-distance-<=2 counting of candidate k-mers
against sampled read windows.

Architecture (a re-design, not a port):
  * ``core``    -- vectorized 2-bit codec, DUST complexity, total ordering
                   (ref: approx_counter.cpp:55-78, 214-305)
  * ``io``      -- FASTA/FASTQ readers (Python + native C++), exporters,
                   timestamped logger (ref: approx_counter.cpp:85-94, 143-174,
                   824-825)
  * ``config``  -- CLI + config-file layering (ref: approx_counter.cpp:103-135,
                   604-669, 700-758)
  * ``sample``  -- read-end window sampler (ref: approx_counter.cpp:415-476)
  * ``count``   -- exact counting via sort/segment-sum + selection
                   (ref: approx_counter.cpp:275-305, 372-405, 487-519)
  * ``kernels`` -- edit-distance counting of candidates x windows (a
                   Pallas/Triton GPU kernel beside the plain Myers scan)
                   replacing the reference's FM-index search
                   (ref: approx_counter.cpp:531-601)
  * ``dist``    -- shard_map data-parallel orchestration over a device mesh
                   (new component; the reference is OpenMP-only)
  * ``synth``   -- seeded nanopore-like FASTQ read sets for end-to-end runs
"""

__version__ = "0.1.0"

from approx_counter_tpu.params import Params  # noqa: F401
