"""The compute service's parts ported so far: the structural plan
fingerprint (``cache.py``). The service itself comes with ROADMAP Queue 1
item 11c."""
