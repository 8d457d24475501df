"""Circle and line polynomials, twiddles."""
