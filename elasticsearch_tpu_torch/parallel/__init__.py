"""Device serving engines and their Hopper kernels."""
