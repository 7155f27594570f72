"""IMPALA systems."""
