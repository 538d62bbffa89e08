"""Diagnostics run by hand on the card; nothing of the served path imports them."""
