"""Plots, frames and the live terminal view (`viz/plotting.py`)."""
