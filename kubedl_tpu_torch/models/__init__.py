"""Model families of the port (llama so far) and their artifact I/O."""
