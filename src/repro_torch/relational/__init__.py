"""Relational substrate: columnar tables, TPC-H-derived data generation,
query templates, and vectorized operators."""
