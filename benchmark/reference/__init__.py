"""Plain references of the configurations, one module each, named as the
configuration; they import nothing of the system under test."""
