"""Training of the port: the stage-1 train step (`step`), the parameter
freeze (`freeze`), the optimizer with its learning-rate schedule
(`schedule`), the Trainer loop (`trainer`) and the CLI (`__main__`)."""
