"""The device object of the Array API surface. Counterpart of
``cubed_tpu/array_api/device.py``: one logical placeholder. Where chunks run
is the executor's and ``backend_array_api.get_device``'s choice, made when
the plan computes."""


class Device:
    def __init__(self, name: str):
        self.name = name

    def __repr__(self) -> str:
        return self.name

    def __eq__(self, other) -> bool:
        return (isinstance(other, Device) and other.name == self.name) or other == self.name

    def __hash__(self):
        return hash(self.name)


device = Device("cubed-tpu-torch")
