"""Models: layers, token mixers, the RecNext backbone and its registry."""
