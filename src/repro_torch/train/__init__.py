"""Training substrate of the port: optimizer, train step, data pipeline,
checkpointing, elastic/straggler logic, gradient compression. Plain torch
and numpy over the reference's parameter trees; the checkpoint format is
the reference's."""
