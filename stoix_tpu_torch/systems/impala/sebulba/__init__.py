"""Sebulba IMPALA systems."""
