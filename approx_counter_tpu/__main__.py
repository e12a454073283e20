"""CLI entry point: ``python -m approx_counter_tpu <input> [flags]``.

Flag-compatible with the reference ``adaptFinder`` binary
(/root/reference/approx_counter.cpp:604-669).
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> int:
    from approx_counter_tpu.compile_cache import enable_compile_cache
    from approx_counter_tpu.config.cli import resolve_params
    from approx_counter_tpu.io.fastx import InputFormatError

    prm = resolve_params(sys.argv[1:] if argv is None else argv)
    enable_compile_cache()

    import contextlib

    ctx = contextlib.nullcontext()
    if prm.profile_dir:
        import jax

        ctx = jax.profiler.trace(prm.profile_dir)

    try:
        with ctx:
            if prm.multihost:
                from approx_counter_tpu.dist.multihost import (
                    run_pipeline_multihost,
                )

                return run_pipeline_multihost(prm)
            from approx_counter_tpu.pipeline import run_pipeline

            return run_pipeline(prm)
    except FileNotFoundError as e:
        sys.stderr.write(f"/!\\ ERROR: COULD NOT OPEN FILE {e.args[0]}\n")
        return 1
    except InputFormatError as e:
        # Malformed input contract (COMPAT #19): parser errors (truncated
        # FASTQ, quality-length mismatch, unrecognized format) exit 1 with
        # the /!\ prefix.  The reference lets SeqAn's throw escape main ->
        # std::terminate with a platform-defined status; a clean error is
        # a strict refinement (same family as COMPAT #16).  Deliberately
        # NOT a bare ValueError catch: an internal bug's ValueError must
        # traceback, not masquerade as bad input.
        sys.stderr.write(f"/!\\ ERROR: {e}\n")
        return 1


if __name__ == "__main__":
    sys.exit(main())
