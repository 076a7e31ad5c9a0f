"""One general driver per kind of traffic mix (``mixes/<name>.json``'s
``kind``): its set-up, its measured window and its correctness check."""
