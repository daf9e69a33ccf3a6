"""The seg train step and its optimizer."""
