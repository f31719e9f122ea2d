"""The ISSGD loop of the port: importance primitives, weight store,
sampler, variance monitors, scorers and the train step."""
