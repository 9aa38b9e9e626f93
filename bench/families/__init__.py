"""The program's side of each model family: weights made from the seed on
the device, packed through the program's own plans, and the entries the
timed window drives."""
