"""Device-resident operators of the Krylov path (one card)."""
