"""The sharded apps' shared plumbing (the apps themselves come later)."""
