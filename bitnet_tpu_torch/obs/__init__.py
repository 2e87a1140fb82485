"""Observability: timing of the card's work."""
