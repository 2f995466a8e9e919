"""Training of the port: the stage-1 train step (`step`), the parameter
freeze (`freeze`) and the optimizer with its learning-rate schedule
(`schedule`)."""
