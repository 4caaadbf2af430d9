"""Models of the port: stage libraries, one package per architecture."""
