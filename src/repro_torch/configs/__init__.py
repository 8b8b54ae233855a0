"""The paper's TM configurations (the port's own copy)."""
