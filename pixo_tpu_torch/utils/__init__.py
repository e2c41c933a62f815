"""Helpers: synthetic inputs and the shared-library builder."""
