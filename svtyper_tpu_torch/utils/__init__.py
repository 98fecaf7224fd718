"""Shared test and smoke helpers."""
