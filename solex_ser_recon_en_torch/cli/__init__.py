"""Command line front end."""
