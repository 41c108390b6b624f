"""The SNHT changepoint core the post-infill flags need (C++, built with
``g++`` at first use)."""
