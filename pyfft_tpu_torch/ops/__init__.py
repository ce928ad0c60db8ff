"""Executors: the row kernel with its plain version, and table builders."""
