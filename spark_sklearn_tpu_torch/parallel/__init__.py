"""Device config and host-side task-grid lowering."""
