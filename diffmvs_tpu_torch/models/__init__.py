"""Stage heads, diffusion refinement and the top model."""
