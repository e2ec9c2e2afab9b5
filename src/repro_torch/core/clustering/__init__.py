"""Similarity measures, Ward linkage, tree cut and the clusterer registry."""
