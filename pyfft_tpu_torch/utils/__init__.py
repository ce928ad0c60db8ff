"""Radix math and device timing."""
