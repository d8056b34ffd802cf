"""Linear-system solvers: the dense closed-form Cholesky solve."""
