"""Work counts: what a kernel or the model has to compute and move, from the
shapes and masks of its calls, whatever implements it."""
