"""Model families of the port (llama, with Gemma's knobs; moe) and their
artifact I/O."""
