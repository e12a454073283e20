from approx_counter_tpu.kernels.bpm import (  # noqa: F401
    approx_counts,
    approx_counts_jnp,
    approx_counts_kernel,
    build_peq,
)
