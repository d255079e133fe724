"""Published configurations of the model families the port serves."""
