"""Evaluation of the port: the numpy metric pass (`metrics`) and the
device pass over a model (`evaluator`)."""
