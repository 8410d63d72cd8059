"""The threaded executor's links between the server and the workers."""
