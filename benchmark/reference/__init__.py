"""The plain reference: GRU4Rec in float32 PyTorch (TF32 off), written from
the model's published equations. It imports nothing of the program and
takes nothing that the program made: the benchmark hands it the same
weights, clicks and negatives that it hands the program."""
