"""End-to-end quality runs of the port on synthetic scenes with known
ground truth: `quality_run` (all five stages, scored on the reference's
quality axes) and `synthetic_convergence` (stage 0 to 4,000 iterations),
both on scenes built by `synthetic`."""
