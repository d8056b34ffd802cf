"""External integrations (ASE calculator)."""
