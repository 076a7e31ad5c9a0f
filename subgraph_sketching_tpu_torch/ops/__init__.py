"""Graph ops of the port: the padded-tree plan (``segment_scan``), its
hand-written merge kernel K1 (``segscan``), and the GCN normalisation
(``graph_ops``)."""
