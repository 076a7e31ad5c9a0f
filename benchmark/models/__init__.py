"""One file per model the program trains (``<model>.py``, the model's
name in lower case), found by ``spec.load_model``: the program's trainer
for that model, the widths its counts need and the FLOPs of its links.
Its plain reference is ``reference/<model>.py``."""
