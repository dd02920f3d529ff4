"""Model configurations of the port (the JSC MLPs)."""
