"""Steps (the training step and the forward-render step) and the
optimizer with its learning-rate schedules."""
