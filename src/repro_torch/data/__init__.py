"""The training input pipeline on the optimized data-flow plane."""
