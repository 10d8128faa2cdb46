"""Bench entry points of the port: `headline`, `block_ab`, `extra`,
`serve`."""
