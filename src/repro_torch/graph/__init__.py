"""Streaming graph generators (GraphChallenge-style SBM and R-MAT)."""
