"""Frozen input generators, made from a seed."""
