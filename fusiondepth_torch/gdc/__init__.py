"""Graph-based depth correction (stage 2's offline teacher)."""
