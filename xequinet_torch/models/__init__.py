"""Model blocks of the port (XPaiNN and its heads)."""
