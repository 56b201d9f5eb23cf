"""Entry points of the port: inference, training and molecular dynamics."""
