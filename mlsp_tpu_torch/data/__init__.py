"""Data for the port: synthetic clouds (datasets and pipelines come with
the trainer slice, ROADMAP.md)."""
