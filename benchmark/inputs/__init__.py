"""Seeded input generators: the graph, node features, supervision links
and the model weights.  Frozen here so that no change to the program
moves the yardstick; the same seed gives the same inputs on the same
device."""
