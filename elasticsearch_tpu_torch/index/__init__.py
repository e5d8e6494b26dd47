"""Index structures the port serves from."""
