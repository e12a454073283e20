"""Run parameters and their resolution.

Mirrors the reference's three-layer precedence (defaults < config file < CLI,
/root/reference/approx_counter.cpp:700-758) with the *code* defaults
(approx_counter.cpp:700-715) -- the reference's --help text drifts from the
code (sn 10k vs 40000, lc 1.5 vs 1.0); the code values are authoritative.

Framework extensions (documented, absent from the reference):
  * ``seed``      -- deterministic sampling; None reproduces the reference's
                     OS-entropy nondeterminism (approx_counter.cpp:427-429).
  * ``compat_quirks`` -- when True, reproduce the reference's skip_end+muted
                     verbosity bug faithfully: the break at
                     approx_counter.cpp:943-948 sits inside ``if(mr_v>0)``
                     AND ``bottom = true`` sits in the *else* of
                     ``if(skip_end)`` (:950-952), so a muted ``-se`` run does
                     a second pass that RE-SAMPLES THE START (fresh shuffle,
                     sl-base prefix windows) and exports it under ``.end``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Params:
    input_file: str = ""
    output: str = "out.txt"          # -o   (approx_counter.cpp:701)
    exact_out: str = ""              # -e   (:702)
    config_file: str = ""            # -conf (:703)
    forbid_kmer: str = ""            # -fk  (:704)
    solid_km: int = 0                # -sk  (:705)
    nb_thread: int = 4               # -nt  (:706) -- compat only; device
    #                                   parallelism comes from the mesh
    k: int = 16                      # -k   (:707), 2 <= k <= 32
    sl: int = 100                    # -sl  (:708)
    sn: int = 40000                  # -sn  (:709)
    limit: int = 500                 # -lim (:710)
    param_lc: float = 1.0            # -lc  (:711)
    v: int = 1                       # -v   (:712)
    skip_end: bool = False           # -se  (:713)
    nb_of_runs: int = 1              # -mr  (:714)
    # --- framework extensions ---
    seed: int | None = None
    compat_quirks: bool = False
    stream: bool = False        # bounded-memory streaming IO + reservoir
    #                             sampling (io/stream.py)
    from_exact: str = ""        # resume: candidate list from a prior exact
    #                             export instead of re-counting (SURVEY §5)
    multihost: bool = False     # SPMD multi-host driver (dist/multihost.py);
    #                             input may be comma-separated file shards
    profile_dir: str = ""       # dump a jax.profiler trace of the run here
    max_error: int = 2          # edit-distance bound (reference hardcodes 2
    #                             at compile time, approx_counter.cpp:25)
    device_pool: str = "auto"   # device-resident window pool for multi-pass
    #                             runs: "auto" (cost model), "on", "off"
    #                             (pipeline.py build_pool)
    bpm_impl: str | None = None  # approximate-count implementation, one
    #                             of kernels/bpm.py IMPLS ("jnp", "kernel");
    #                             None = the backend's default

    def validate(self) -> None:
        """approx_counter.cpp:781-787."""
        if self.k < 2 or self.k > 32:
            raise ValueError(
                "/!\\ ERROR: kmer size must be between 2 and 32 (included)"
            )
        if self.k > self.sl:
            raise ValueError(
                "/!\\ ERROR: kmer size must be smaller than the sampling "
                "length (k <= sl)"
            )

    @property
    def adjusted_lc(self) -> float:
        """approx_counter.cpp:790 -- threshold rescaled from the k=16 base."""
        from approx_counter_tpu.core.complexity import adjust_threshold

        return adjust_threshold(self.param_lc, 16, self.k)

    @property
    def mr_v(self) -> int:
        """Multi-run verbosity muting (approx_counter.cpp:771-775)."""
        if self.nb_of_runs > 1 and self.v < 2:
            return 0
        return self.v
