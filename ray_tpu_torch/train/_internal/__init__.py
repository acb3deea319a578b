"""Worker-side internals of the port's Train: the session, the worker group
and the backend executor."""
